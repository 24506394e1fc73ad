"""Share of a control step's time in which no operation ran on the device:
one minus the device's busy seconds a step in the traced segment (the
union of its kernel, copy and set intervals) over the host seconds a step
of the untraced window.  The profiler slows the host, not the device, so
the traced segment's own length would overstate the idle share."""


def read(ctx):
    seg = ctx.segment
    if (seg is None or not seg.device_ops or not ctx.traced_steps or not ctx.control_steps
            or not ctx.window_s):
        return None
    busy = seg.busy_s / ctx.traced_steps
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.control_steps))
