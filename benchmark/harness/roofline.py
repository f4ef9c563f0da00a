"""The frozen operation count of one helix push and the peaks it is held
to, for the kernels' roofline shares.

A push is one helix (or retro) step of one lane, as an algorithm: the
same count whichever kernel computes it (K5, csrc/helix_step.cu, or K1,
csrc/mega_step.cu), so that a kernel that drops work shows as a faster
kernel and not as a smaller count.

* ``FLOAT_OPS_PER_PUSH``: the step's floating-point operations (zone
  fields, scattering of the pitch angle, the gyration and the move, the
  frame transforms of a crossing and the exit tests), at the cell's
  momentum precision: float64 in the float64 cells, float32 in the
  float32 cells.  230, the count taken from K5's source in PR 10 of the
  port, frozen here.
* ``INT_OPS_PER_PUSH``: the random bits a step needs: 8 uniforms of 16
  bits are 128 bits, two blocks of Threefry-2x32-20, each 20 rounds of
  an add, a rotate (one funnel shift) and a xor, with 5 key injections
  of 3 adds and the 2 adds of the counter: 2 x 77 = 154 32-bit integer
  operations.  (K5 draws its stream as the JAX package's fold_in and
  bits, five blocks a step; the algorithm needs two.)
* No bytes: a lane's state stays in registers for a whole drain, and a
  push's deposit is a few bytes against hundreds of operations.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet and
the Hopper whitepaper: 132 SMs, 1.98 GHz boost): 34 TFLOP/s float64 and
67 TFLOP/s float32 outside the tensor cores, and 64 32-bit integer
operations a clock an SM, 16.7 T/s.  The least time of N pushes is the
largest of the classes' times, each class on its own pipe at its peak:
the pipes overlap, so the share cannot pass 100% while the counts hold.
"""

from __future__ import annotations

FLOAT_OPS_PER_PUSH = 230
INT_OPS_PER_PUSH = 2 * 77
PEAK_FLOPS = {"float64": 34.0e12, "float32": 67.0e12}
PEAK_INT32_OPS = 132 * 64 * 1.98e9


def least_seconds(pushes: int, p_dtype: str) -> float:
    """The least time the chip could take for `pushes` helix pushes with
    momenta in `p_dtype` ('float64' or 'float32')."""
    return pushes * max(FLOAT_OPS_PER_PUSH / PEAK_FLOPS[p_dtype],
                        INT_OPS_PER_PUSH / PEAK_INT32_OPS)


def share_pct(pushes: int, p_dtype: str, kernel_seconds: float):
    """A kernel's share of its roofline [%] over `kernel_seconds` of its
    device time, or None where it did not run."""
    if not kernel_seconds > 0 or pushes <= 0:
        return None
    return 100.0 * least_seconds(pushes, p_dtype) / kernel_seconds
