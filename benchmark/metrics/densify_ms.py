"""A densify pass (densify_and_prune and the capacity check): the median
device ms of the profiled window's `densify` spans of the program (children
of the training loop's `iteration` root)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "densify")
