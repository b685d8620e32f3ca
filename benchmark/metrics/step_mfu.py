"""The whole training step's share of the card's fp32 peak: the reference's
work of a step (work.step_ops: projection and its gradient, compositing both
ways, the loss both ways, Adam) over the traced run's time a step by the
host's clock (its profiled window over its steps, idle time included)."""

from benchmark import work


def read(run):
    ops = work.step_ops(run.work, run.pixels, run.params_per_splat, run.live)
    return work.mfu(ops, run.unit_seconds)
