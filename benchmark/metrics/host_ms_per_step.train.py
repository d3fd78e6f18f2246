"""Host time of the port's ``mseg.train_step`` spans
(``Trainer.train_step``: augmentation, forward, backward and the optimizer
step enqueued, with no sync) in the traced sub-window, per training step
there."""

from benchmark.harness.spans import host_s


def read(ctx):
    tw, s = ctx["traced"], host_s("mseg.train_step")
    if not s or not tw or not tw.get("steps"):
        return None
    return s * 1e3 / tw["steps"]
