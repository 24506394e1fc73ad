"""Device-to-host reads that decide a branch in the solver
(`ops/qp.solve_batched`; the port's counter `ops/qp.HOST_SYNCS`), per
control step of the window."""


def read(ctx):
    if ctx.host_syncs is None or not ctx.control_steps:
        return None
    return ctx.host_syncs / ctx.control_steps
