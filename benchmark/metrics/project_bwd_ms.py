"""The backward through the pair table's packing, the projection and SH, a
step: the median, over the window's steps, of the device ms from the
program's `backward.raster` span's end to its parent `backward`'s end."""

from benchmark import spans


def read(run):
    return spans.backward_part(run, "after")
