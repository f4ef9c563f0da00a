"""Array-capacity and regime parameters.

Mirrors the Julia reference's src/parameters.jl:1-33.  In the TPU framework
most array extents are derived from the config at trace time (static
shapes for XLA), so these act as validated ceilings / defaults rather
than Fortran-style fixed allocations.
"""

# Max number of particles at each pcut (parameters.jl:9)
NA_PARTICLES = 100_000
# Max number of elements in the pcut array (parameters.jl:11)
NA_C = 100
# Max number of PSD bins per axis (parameters.jl:18)
PSD_MAX = 200
# Number of bins in the thermal injection distribution (parameters.jl:20)
NUM_THERM_BINS = 150
# Max thermal-crossing records in the reference before file spill
# (parameters.jl:24).  Unused here: thermal crossings are histogrammed
# directly on-chip instead of being kept as a list.
NA_CR = 10 * NA_PARTICLES
# Max size of photon arrays (parameters.jl:26)
NA_PHOTONS = 300

# Relativistic-regime cutoffs (parameters.jl:30-32)
BETA_REL_FL = 0.02   # fluid: beta >= this => use relativistic fluid equations
E_REL_PT = 0.005     # particle: (gamma-1) >= this => relativistic particle forms

# Hard cap on helix steps per particle per pcut segment; the reference
# escapes a particle with i_reason=1 after 10_000 steps
# (particle_loop.jl:162-165).  Env-overridable: the Keshet-Waxman
# pitch-angle-diffusion validation (N_g ~ 1e4 steps/gyroperiod) needs
# far more steps per segment than the default cap allows
# (scripts/flagship_keshet_waxman.py).
import os as _os

MAX_HELIX_STEPS = int(_os.environ.get("MCS_MAX_HELIX_STEPS", 10_000))

# 1/cosine spike clamp used when tallying fluxes (all_flux.jl:4)
ALL_FLUX_SPIKE_AWAY = 1000.0
# same clamp in particle_finish (particle_finish.jl:5)
PF_SPIKE_AWAY = 1000.0
