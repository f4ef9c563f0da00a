"""Nonthermal photon emission: synchrotron, inverse Compton, pi0 decay."""

from .driver import EmissionResult, photon_calcs  # noqa: F401
