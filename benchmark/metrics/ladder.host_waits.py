"""ladder.host_waits: the host's waits for the device a run, from the
trace: calls of cudaStreamSynchronize, cudaDeviceSynchronize and
cudaEventSynchronize, and device-to-host copies (harness/trace.py)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.host_waits / len(ctx.runs)
