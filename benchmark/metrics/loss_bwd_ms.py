"""The backward through the loss, the background blend and untile, a step:
the median, over the window's steps, of the device ms from the program's
`backward` span's start to its child `backward.raster`'s start."""

from benchmark import spans


def read(run):
    return spans.backward_part(run, "before")
