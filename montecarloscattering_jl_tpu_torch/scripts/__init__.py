"""Measurement scripts of the port (run as modules, on a CUDA card)."""
