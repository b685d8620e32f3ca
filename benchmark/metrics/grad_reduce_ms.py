"""The per-Gaussian gradient reduction a step (the key sort, K4 and
segment_sum): the median device ms of the window's
`backward.raster.reduce` spans of the program."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "backward.raster.reduce")
