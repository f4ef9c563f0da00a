"""PyTorch + CUDA port of montecarloscattering_jl_tpu for NVIDIA Hopper.

The JAX package beside it is the reference.  This package keeps its
layout so each module's counterpart is easy to find:

utils     constants, parameters, species, config, root finders,
          cosmology, phase timers (host, copied from the JAX package's
          ``utils``: importing that one would load the JAX package)
models    grid / jump conditions / profile / injection / PSD bins
          (host NumPy, copied; the PSD bin lookups are torch)
ops       RNG, particle state, the transport kernel K1 and its twin,
          exit bookkeeping, pcut splitting, reductions (torch)
engine    setup, the pcut ladder, the iteration driver, output files
csrc      CUDA C++ sources of the hand-written kernels
"""

__version__ = "0.1.0"
