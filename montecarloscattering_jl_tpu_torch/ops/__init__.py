"""Transport kernels and device-side reductions, in torch and CUDA."""
