"""Physics models: shock initialization, jump conditions, PSD bins."""

from . import fluxes, grid, injection, profile, psd_bins, rankine_hugoniot  # noqa: F401
