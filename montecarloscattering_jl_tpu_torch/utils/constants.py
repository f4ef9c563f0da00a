"""Physical constants in Gaussian CGS units.

Replaces the reference's Unitful.jl dimensioned constants
(the Julia reference's src/constants.jl:1-32, cgstypes.jl:1-22) with plain
float64 CGS values.  Dimensional correctness lives in the unit tests
rather than in the type system: all quantities in this framework are
bare floats in the units documented here.

Unit conventions (CGS-Gaussian, matching the reference):
    length      cm
    time        s
    mass        g
    momentum    g cm / s
    energy      erg
    B field     Gauss  (B^2 / 8 pi = energy density in erg/cm^3)
    charge      esu (Fr)
    temperature K
"""

import math

# --- fundamental constants (CODATA 2018, as used by PhysicalConstants.jl) ---
C_CGS = 2.99792458e10            # speed of light [cm/s]
MP_CGS = 1.67262192369e-24       # proton mass [g]
ME_CGS = 9.1093837015e-28        # electron mass [g]
QE_CGS = 4.80320471257e-10       # elementary charge [esu]
KB_CGS = 1.380649e-16            # Boltzmann constant [erg/K]
H_CGS = 6.62607015e-27           # Planck constant [erg s]
HBAR_CGS = 1.054571817e-27       # reduced Planck constant [erg s]
SIGMA_T = 6.6524587321e-25       # Thomson cross section [cm^2]

# --- unit conversions ---
EV_ERG = 1.602176634e-12         # 1 eV in erg
KEV_ERG = 1.602176634e-9         # 1 keV in erg
MEV_ERG = 1.602176634e-6         # 1 MeV in erg
GEV_ERG = 1.602176634e-3         # 1 GeV in erg
KM_CM = 1.0e5                    # 1 km in cm
PC_CM = 3.0856775814913673e18    # 1 parsec in cm
KPC_CM = 1.0e3 * PC_CM
MPC_CM = 1.0e6 * PC_CM
YEAR_S = 3.15576e7               # Julian year in s

# --- derived rest energies / momenta ---
MP_C = MP_CGS * C_CGS            # proton momentum unit m_p c [g cm/s]
MP_C2 = MP_CGS * C_CGS**2        # proton rest energy [erg]
ME_C2 = ME_CGS * C_CGS**2        # electron rest energy [erg]
AA_ELECTRON = ME_CGS / MP_CGS    # electron mass in proton masses

# --- CMB (reference constants.jl:10-12) ---
B_CMB0 = 3.27e-6                 # equivalent B field of CMB energy density at z=0 [G]
T_CMB0 = 2.725                   # CMB temperature at z=0 [K]

# --- pion production constants (reference constants.jl:15-22), in GeV ---
T_TH_GEV = 0.2797                # threshold proton kinetic energy for pi0 production
M_RES_GEV = 1.1883               # resonance mass
GAMMA_RES_GEV = 0.2264           # resonance width
E0_PI0_GEV = 0.134976            # neutral pion rest energy
MP_GEV = MP_C2 / GEV_ERG         # proton rest mass in GeV

# --- synchrotron / IC radiative loss prefactor (reference constants.jl:30) ---
# dp/dt = -RAD_LOSS_FAC * p^2 * B_eff^2 with p in g cm/s, B in G; follows
# Sturner+ (1997) Eq 16 averaged over pitch angle, converted from dE/dt to
# dp/dt (extra 1/c).  Units: s^2 / g^2.
RAD_LOSS_FAC = (4.0 / 3.0) * C_CGS * SIGMA_T / (C_CGS**3 * ME_CGS**2 * 8.0 * math.pi)
