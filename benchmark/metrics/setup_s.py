"""Set-up: from the process's start to the measured window (imports, the
inputs and weights made from the seed, the model and engine built, the
kernels built or loaded, every shape warmed up)."""


def read(ctx):
    return ctx["setup_s"]
