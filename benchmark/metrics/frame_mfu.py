"""The whole viewer frame's share of the card's fp32 peak: the reference's work
of a frame (work.frame_ops: projection, compositing, the bytes) over the
traced run's median frame latency by the host's clock."""

from benchmark import work


def read(run):
    return work.mfu(work.frame_ops(run.work, run.pixels), run.unit_seconds)
