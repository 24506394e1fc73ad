"""Median host time of one control step over the window (each step ends in a
device synchronise): the steadier companion of the end-to-end tail."""
import statistics


def read(ctx):
    return statistics.median(ctx.step_ms) if ctx.step_ms else None
