"""setup_s: seconds from the process's start to the end of the warm-up job
(imports, the CUDA context, the kernels built or loaded, the network made,
profiled where the mix profiles once, and one job of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
