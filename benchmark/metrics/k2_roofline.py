"""K2 composite_fwd's share of its roofline, a step or frame: the
reference's work (work.k2: blends and the rows and pixels they need,
counted on the seed's scene) over the device seconds of the kernels named
`composite_fwd` in the profiler's trace, a step or frame."""

from benchmark import work


def read(run):
    ops, nbytes = work.k2(run.work, run.pixels)
    return work.roofline_share(ops, nbytes, run.kernel_seconds("composite_fwd"))
