"""Process start to the first timed sweep: imports, CUDA context, the
kernels' libraries (built on a checkout's first run), the model, the
images and one warm-up sweep of the cell's grid."""


def read(ctx):
    return ctx.setup_s
