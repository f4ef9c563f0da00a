"""setup_s: seconds from the process's start to the window's start
(imports, kernels loaded or built, the configuration read, one warm-up
iteration), on the host's clock."""


def read(ctx):
    return ctx.setup_s
