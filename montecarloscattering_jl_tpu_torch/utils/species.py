"""Particle species description.

Mirrors the reference `Species` struct (src/utils.jl:72-96)
and its accessors, plus small kinematics helpers (utils.jl:62-69).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .constants import C_CGS, MP_CGS, QE_CGS


@dataclass(frozen=True)
class Species:
    """One ion (or electron) species.

    Attributes
    ----------
    mass : float
        Rest mass [g].
    charge : float
        Charge [esu]; negative for electrons.
    temperature : float
        Far-upstream temperature [K].
    number_density : float
        Far-upstream number density [cm^-3].
    """

    mass: float
    charge: float
    temperature: float
    number_density: float

    @property
    def aa(self) -> float:
        """Mass in units of the proton mass."""
        return self.mass / MP_CGS

    @property
    def zz(self) -> float:
        """Charge in units of the elementary charge."""
        return self.charge / QE_CGS

    @property
    def rest_energy(self) -> float:
        """Rest energy m c^2 [erg]."""
        return self.mass * C_CGS**2

    @property
    def mc(self) -> float:
        """Momentum scale m c [g cm/s]."""
        return self.mass * C_CGS

    @property
    def is_electron(self) -> bool:
        """True when lighter than a proton (reference tests `aa < 1`)."""
        return self.aa < 1.0


def lorentz(beta: float) -> float:
    """Lorentz factor from beta (utils.jl:62)."""
    return 1.0 / math.sqrt(1.0 - beta * beta)


def beta_of_gamma(gamma: float) -> float:
    """beta from Lorentz factor (utils.jl:69)."""
    return math.sqrt(1.0 - 1.0 / (gamma * gamma))
