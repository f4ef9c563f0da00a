"""k1_roofline: K1's share of its roofline: the least time of the
window's pushes (harness/roofline.py's frozen count a push, at the
cell's momentum precision) over the device time of K1's kernel in the
trace.  None where K1 did not run."""

from harness import roofline

KERNELS = ("mega_step_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    return roofline.share_pct(sum(r.pushes for r in ctx.runs), ctx.p_dtype,
                              ctx.trace.kernel_seconds(KERNELS))
