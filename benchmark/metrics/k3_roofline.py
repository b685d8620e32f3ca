"""K3 composite_bwd's share of its roofline a step: the reference's work of a
step (work.k3: the blends' gradients, the rows read and written, the pixels)
over the device seconds of the kernels named `composite_bwd` in the
profiler's trace, a step."""

from benchmark import work


def read(run):
    ops, nbytes = work.k3(run.work, run.pixels)
    return work.roofline_share(ops, nbytes, run.kernel_seconds("composite_bwd"))
