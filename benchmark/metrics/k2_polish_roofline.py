"""Roofline share of K2, the compact-H polish kernel
(csrc/polish.cu): the least time its traced launches need
(each launch's operations and bytes from its own batch and iterations,
`benchmark/roofline.py`, against the published peaks) over their device
time in the trace.  Silent when the segment launched none of it, or the
trace shows no kernel of these names."""

CALL = "polish_solve_compact"  # the launch records' name (`benchmark/spy.py`)
KERNELS = ("polish_kernel<float, qwbc::CompactH",)  # the kernel's name in the device trace


def read(ctx):
    if ctx.segment is None or ctx.spy is None:
        return None
    device_s = ctx.segment.kernel_seconds(KERNELS)
    bound_s = ctx.spy.bound_seconds(CALL)
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s
