"""Share of the traced sub-window in which the card idled while the host
was inside one of the port's ``mseg.`` spans and no operator or runtime
call: the shortest host event covering the middle of the idle gap
(``harness/trace.py``) is such a span, so the gap is Python in the engine
(a stage's own code, or the segment call's between its stages)."""

from benchmark.harness.spans import recorded

PREFIX = "mseg."


def read(ctx):
    t = ctx["trace"]
    if t is None or t.window_s <= 0 or not recorded()["spans"]:
        return None
    idle = sum(v for k, v in t.idle.items() if k.startswith(PREFIX))
    return 100.0 * idle / t.window_s
