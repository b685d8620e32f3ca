"""Device busy time as a union of intervals, idle gaps named by the host, time
by kernel, from Chrome-trace events."""

from benchmark import trace


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]


def test_busy_share_counts_overlap_once_and_clips():
    iv = [(0, 4), (2, 6), (8, 12)]
    assert trace.busy_share(iv, 0, 10) == 0.8
    assert trace.idle_gaps(iv, 0, 10) == [(6, 8)]
    assert trace.idle_gaps([], 0, 10) == [(0, 10)]


def test_summarize_names_gaps_by_the_host():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 0, "dur": 60},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "composite_fwd_kernel<false>", "ts": 0, "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "sort", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "composite_fwd_kernel<false>", "ts": 80, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "after", "ts": 150, "dur": 10},
    ]
    s = trace.summarize(ev)
    assert abs(s["window_s"] - 100e-6) < 1e-15
    assert abs(s["busy_s"] - 60e-6) < 1e-15
    assert abs(s["kernels"]["composite_fwd_kernel<false>"] - 40e-6) < 1e-15
    assert "after" not in s["kernels"]
    assert s["device_ops"][0][0] == "composite_fwd_kernel<false>"
    gaps = dict(s["idle_gaps"])
    assert abs(gaps["bench.step / cudaStreamSynchronize"] - 20e-6) < 1e-15
    assert abs(gaps["host: no traced event"] - 20e-6) < 1e-15
