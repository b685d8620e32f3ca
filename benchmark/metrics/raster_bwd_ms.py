"""The rasterizer's backward a step (`_Rasterize.backward`: K3, the
contributing regions, the key sort, K4, segment_sum): the median device ms
of the window's `backward.raster` spans of the program."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "backward.raster")
