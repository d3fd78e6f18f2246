"""Share of the traced sub-window in which no kernel, copy or memset ran on
the card (the union of their intervals)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
