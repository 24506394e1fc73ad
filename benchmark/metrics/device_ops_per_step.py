"""Device operations (kernels, copies, sets) per control step of the traced
segment."""


def read(ctx):
    seg = ctx.segment
    if seg is None or not seg.device_ops or not ctx.traced_steps:
        return None
    return seg.device_ops / ctx.traced_steps
