"""k5_roofline: K5's share of its roofline: the least time of the
window's pushes (harness/roofline.py's frozen count a push, at the
cell's momentum precision) over the device time of K5's kernels in the
trace.  None where K5 did not run."""

from harness import roofline

KERNELS = ("helix_drain_kernel", "helix_step_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share_pct(sum(r.pushes for r in ctx.runs), ctx.p_dtype,
                              ctx.trace.kernel_seconds(KERNELS))
