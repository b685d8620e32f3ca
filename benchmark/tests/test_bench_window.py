"""The window's arithmetic: a rate over the whole window, the latency
percentiles over every frame, the seeded sample of frames."""

import statistics

from benchmark import harness

TRAIN = harness.load_driver("train")
VIEW = harness.load_driver("view")


def test_step_ms_is_the_whole_window_over_its_steps():
    assert TRAIN.per_step_ms(10.5, 350) == 30.0


def test_latency_percentiles_over_all_frames():
    lat = [0.010 + 0.001 * (i % 7) for i in range(300)] + [0.050] * 20
    got = VIEW.latency_ms(lat)
    assert got["frame_ms_p50"] == statistics.median(lat) * 1e3
    # 320 frames: the 95th percentile lies among the 20 slow ones' neighbours
    srt = sorted(lat)
    assert srt[int(0.94 * 320)] * 1e3 <= got["frame_ms_p95"] <= srt[-1] * 1e3
    assert got["frame_ms_p95"] == statistics.quantiles(lat, n=20)[-1] * 1e3
    assert VIEW.latency_ms([0.02]) == {"frame_ms_p50": 20.0, "frame_ms_p95": 20.0}


def test_sample_keeps_k_frames_and_the_slowest():
    def run():
        s = VIEW.Sample(seed=7, k=4, nbytes=2)
        for i in range(1000):
            s.offer(1.0 if i == 333 else 0.01, i, i / 10, bytes([i % 256, 7]))
        return s.items()
    items = run()
    ids = [it[0] for it in items]
    assert len(ids) in (4, 5) and 333 in ids and len(set(ids)) == len(ids)
    assert [it[0] for it in run()] == ids
    for f, yaw, data in items:       # each kept frame's own bytes, copied
        assert yaw == f / 10 and list(data) == [f % 256, 7]


def test_sample_marks_a_reply_of_the_wrong_size():
    s = VIEW.Sample(seed=1, k=2, nbytes=3)
    s.offer(0.1, 0, 0.0, b"abc")
    s.offer(0.2, 1, 0.0, b"ab")
    got = {f: d for f, _, d in s.items()}
    assert list(got[0]) == list(b"abc") and got[1] is None


def test_sample_is_spread_over_the_stream():
    hits = [0] * 10
    for seed in range(300):
        s = VIEW.Sample(seed=seed, k=3, nbytes=1)
        for i in range(100):
            s.offer(0.0, i, 0.0, b"x")
        for it in s.kept:
            hits[it[0] // 10] += 1
    assert min(hits) > 0.5 * max(hits)


def test_leaf_gaps_against_the_larger_of_leaf_and_median():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-9}
    # leaf c is tiny: its gap is measured against the median leaf (1.0)
    assert abs(harness.leaf_gaps(prog, ref, ref) - 0.1) < 1e-12
