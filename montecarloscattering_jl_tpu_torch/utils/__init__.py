"""Foundations: constants, parameters, species, config, small solvers."""

from . import constants, params  # noqa: F401
from .config import ConfigError, RunConfig, config_from_dict, load_config  # noqa: F401
from .species import Species, beta_of_gamma, lorentz  # noqa: F401
