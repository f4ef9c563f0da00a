"""Small scalar root finders used by initialization and smoothing.

The reference leans on Roots.jl Newton solves (initializers.jl:173,
smoothers.jl:408-419, cosmo_calc.jl:43-49).  These run on O(1) or
O(n_grid)=O(99) problems per iteration, so they stay host-side NumPy.
"""

from __future__ import annotations

from typing import Callable


def newton(f: Callable[[float], float], x0: float, *,
           dfdx: Callable[[float], float] | None = None,
           tol: float = 1.0e-12, max_iter: int = 200) -> float:
    """Newton's method with optional analytic derivative.

    Falls back to a central finite difference when `dfdx` is None.
    Convergence test is on the step size relative to max(|x|, 1).
    """
    x = float(x0)
    for _ in range(max_iter):
        fx = f(x)
        if dfdx is not None:
            d = dfdx(x)
        else:
            h = 1.0e-7 * max(abs(x), 1.0e-30)
            d = (f(x + h) - f(x - h)) / (2.0 * h)
        if d == 0.0:
            break
        step = fx / d
        x -= step
        if abs(step) <= tol * max(abs(x), 1.0):
            return x
    return x


def bisect(f: Callable[[float], float], lo: float, hi: float, *,
           tol: float = 1.0e-14, max_iter: int = 200) -> float:
    """Plain bisection; requires a sign change on [lo, hi]."""
    flo = f(lo)
    fhi = f(hi)
    if flo == 0.0:
        return lo
    if fhi == 0.0:
        return hi
    if flo * fhi > 0:
        raise ValueError("bisect: no sign change on bracket")
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        fm = f(mid)
        if fm == 0.0 or (hi - lo) < tol * max(abs(mid), 1.0):
            return mid
        if flo * fm < 0:
            hi = mid
        else:
            lo, flo = mid, fm
    return 0.5 * (lo + hi)
