"""Spatial grid and photon-shell construction.

Mirrors the Julia reference's src/initializers.jl:403-476 (setup_grid with its
hand-tuned zone tables) and :305-399 (set_photon_shells).

Grid conventions in this framework (0-based):
  * ``x_grid_rg`` has ``nb = n_grid + 2`` boundaries, indices 0..nb-1,
    with sentinels x[0] = -1e30 and x[nb-1] = +1e30 (in units of rg0).
  * Zone / boundary index ``i`` for a particle at x means
    ``x_grid[i] <= x < x_grid[i+1]`` — identical to the reference's
    i_grid convention (last boundary <= x).
  * Profile arrays are indexed by boundary (length nb); tally arrays are
    also indexed by boundary, with entries 1..n_grid meaningful.
"""

from __future__ import annotations

import numpy as np

# Hand-set zone tables (initializers.jl:403-419)
FIRST_ZONE = np.array([
    -9.0, -8.0, -7.0, -6.0, -5.0, -4.5, -4.0, -3.5, -3.0,
    -2.5, -2.0, -1.8, -1.6, -1.4, -1.2, -1.0,
    -0.9, -0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2,
    -0.15, -0.1,
    -0.07, -0.05, -0.04, -0.03, -0.02, -0.015, -0.01,
    -3.0e-3, -1.0e-3,
])
EXTREMELY_FINE_SPACING = np.array([-1.0e-4, -1.0e-7, 0.0, 1.0e-7, 1.0e-4])
DOWNSTREAM_SPACING = np.array([
    1.0e-3, 1.0e-2, 2.0e-2, 3.0e-2, 5.0e-2, 7.0e-2, 0.1,
    0.15, 0.2, 0.25, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0,
])

N_LOG_UPSTREAM = 27
N_LOG_DOWNSTREAM = 16
SENTINEL_RG = 1.0e30


def setup_grid(x_grid_start_rg: float, x_grid_stop_rg: float, use_prp: bool,
               feb_downstream: float, rg0: float
               ) -> tuple[np.ndarray, float, float]:
    """Build the grid boundary array in units of rg0
    (initializers.jl:436-476).

    Returns (x_grid_rg [nb], x_grid_start [cm], x_grid_stop [cm]).
    """
    x_grid_start = x_grid_start_rg * rg0
    x_grid_stop = feb_downstream if not use_prp else x_grid_stop_rg * rg0

    # NOTE: the reference computes the upstream log spacing as
    #   dlogx = (log10(-start) - 1)/27 - 1    (initializers.jl:451)
    # which appears to be a typo for ... / 27 (the trailing "- 1" makes
    # the upstream zones overlap FIRST_ZONE for the baseline start of
    # -1e7 rg0).  We span log10(-start) down to log10(10) = 1 in 27 log
    # steps so the last log zone lands just upstream of FIRST_ZONE's
    # -9 rg0 head, preserving the intent of 27 log-spaced upstream zones.
    dlogx = (np.log10(-x_grid_start_rg) - 1.0) / N_LOG_UPSTREAM
    log_up = np.log10(-x_grid_start_rg) - dlogx * np.arange(N_LOG_UPSTREAM)

    pieces = [
        np.array([-SENTINEL_RG]),
        -np.power(10.0, log_up),
        FIRST_ZONE,
        EXTREMELY_FINE_SPACING,
        DOWNSTREAM_SPACING,
    ]

    # Downstream log zones from the last manual zone (+1 rg0) to the
    # grid stop (initializers.jl:466-471).
    x_end_man = DOWNSTREAM_SPACING[-1]
    dlogx_dw = (np.log10(x_grid_stop / rg0) - np.log10(x_end_man)) / N_LOG_DOWNSTREAM
    log_dw = np.log10(x_end_man) + dlogx_dw * (1 + np.arange(N_LOG_DOWNSTREAM))
    pieces.append(np.power(10.0, log_dw))
    pieces.append(np.array([SENTINEL_RG]))

    x_grid_rg = np.concatenate(pieces)
    if not np.all(np.diff(x_grid_rg) > 0):
        raise ValueError("grid boundaries are not strictly increasing")
    return x_grid_rg, x_grid_start, x_grid_stop


def find_shock_index(x_grid_rg: np.ndarray) -> int:
    """Index of the last boundary <= 0 (MonteCarloScattering.jl:478)."""
    idx = np.nonzero(x_grid_rg <= 0.0)[0]
    if idx.size == 0:
        raise ValueError("shock location not found")
    return int(idx[-1])


def find_feb_index(x_grid_cm: np.ndarray, feb_upstream: float) -> int:
    """Index of the boundary just upstream of the FEB
    (MonteCarloScattering.jl:414)."""
    return int(np.searchsorted(x_grid_cm, feb_upstream, side="right")) - 1


def set_photon_shells(num_upstream_shells: int, num_downstream_shells: int,
                      use_prp: bool, feb_upstream: float,
                      feb_downstream: float, rg0: float,
                      x_grid_stop_rg: float
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Log-spaced emission shells on both sides of the shock
    (initializers.jl:305-399).

    Returns (x_shell_midpoints [rg0-units], x_shell_endpoints [cm]).
    """
    total = num_upstream_shells + num_downstream_shells
    mid = np.zeros(total)
    end = np.zeros(total + 1)

    # upstream (initializers.jl:333-365): exponents from -1 up to
    # log10(|feb_up|/rg0), stored upstream-to-downstream with negatives
    width = (np.log10(abs(feb_upstream / rg0)) + 1.0) / num_upstream_shells
    for i in range(1, num_upstream_shells + 1):
        if i == 1:
            x_start, x_end = 0.0, 10.0 ** (-1 + width)
            x_mid = 10.0 ** (-1 + width / 2)
        else:
            x_start = 10.0 ** (-1 + width * (i - 1))
            x_end = 10.0 ** (-1 + width * i)
            x_mid = 10.0 ** (-1 + width * (i - 0.5))
        n = num_upstream_shells - i  # 0-based
        mid[n] = -x_mid
        end[n] = -x_end
        end[n + 1] = -x_start

    # downstream (initializers.jl:371-398)
    limit_dw = x_grid_stop_rg if use_prp else feb_downstream / rg0
    width = (np.log10(limit_dw) + 1.0) / num_downstream_shells
    for i in range(1, num_downstream_shells + 1):
        x_start = 0.0 if i == 1 else 10.0 ** (-1 + width * (i - 1))
        x_mid = 10.0 ** (-1 + width * (i - 0.5))
        x_end = 10.0 ** (-1 + width * i)
        j = num_upstream_shells + i - 1  # 0-based
        end[j] = x_start
        mid[j] = x_mid
        end[j + 1] = x_end

    return mid, end * rg0


def shell_zone_endpoints(x_grid_cm: np.ndarray, x_shell_endpoints: np.ndarray,
                         n_grid: int) -> np.ndarray:
    """Grid boundary indices of the shell endpoints
    (MonteCarloScattering.jl:392-401)."""
    out = np.zeros(len(x_shell_endpoints), dtype=np.int64)
    k = 0
    for i in range(1, n_grid + 1):
        while (k < len(x_shell_endpoints)
               and x_grid_cm[i] <= x_shell_endpoints[k] < x_grid_cm[i + 1]):
            out[k] = i
            k += 1
    return out
