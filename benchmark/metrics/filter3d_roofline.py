"""The 3D filter's kernels' share of their roofline over the profiled
window: the operations and bytes of its passes there (reference_mip's
filter_work: rows times cameras, counted by the driver from the rows each
pass covered) over the device seconds of the kernels named `filter3d` in
the profiler's trace."""

from benchmark import work


def read(run):
    if not run.trace or not run.work or not run.work.get("filter3d_ops"):
        return None
    secs = sum(v for k, v in run.trace["kernels"].items() if "filter3d" in k)
    return work.roofline_share(run.work["filter3d_ops"], run.work["filter3d_bytes"], secs)
