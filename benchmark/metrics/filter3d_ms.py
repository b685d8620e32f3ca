"""A pass of Mip-Splatting's 3D filter over the training cameras: the
median device ms of the profiled window's `filter3d` spans of the program
(children of the training loop's `iteration` root)."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "filter3d")
