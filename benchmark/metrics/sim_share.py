"""Share of the closed loop's time in the simulator: CUDA events at the
benchmark's own `mark` callback, "sim" -> "end" of every control period of
the window over the periods' whole "planner" -> "end" time."""


def read(ctx):
    spans = ctx.spans
    if not spans or not spans.get("period_ms"):
        return None
    return 100.0 * spans["sim_ms"] / spans["period_ms"]
