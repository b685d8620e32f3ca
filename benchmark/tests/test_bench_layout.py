"""BENCHMARK.json against its contract's shape, and the harness finding every
cell's configuration, traffic mix, driver, limits and metric readers by name;
a new cell, traffic kind and metric added as files and entries alone."""

import json
import re
import shutil

import pytest

from benchmark import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_cells_report_what_their_layers_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in CELLS and w in e2e[m["moves"]].get("workloads", CELLS)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs) and all(w["chips"] == 1 for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name)
    assert callable(cell.driver.run)
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer and all(callable(m["reader"]) for m in cell.per_layer)
    assert all(v >= 0 for v in cell.limits.values())


def test_every_reader_file_serves_an_entry():
    files = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    names = {m["name"] for m in SPEC["per_layer"]}
    assert files <= names | {n.split(".")[0] for n in names}


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A configuration, a traffic mix, a metric and a cell, added as new
    files and new entries of a copy of the tree, load with no edit to any
    file that was there."""
    shutil.copytree(harness.BENCH, tmp_path / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "gs3.1m-sparse-1080p.json").read_text())
    cfg.update(name="gs2m-sparse-1080p", n_gaussians=2_000_000, capacity=1 << 21)
    (bench / "configs" / "gs2m-sparse-1080p.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((bench / "traffic" / "view.json").read_text()), sweep_frames=60)
    (bench / "traffic" / "fastview.json").write_text(json.dumps(traffic))
    (bench / "checks" / "big-view.json").write_text(
        (bench / "checks" / "sparse-view.json").read_text())
    (bench / "drivers" / "still.py").write_text("def run(*args):\n    return None\n")
    (bench / "traffic" / "still.json").write_text(json.dumps({"kind": "still"}))
    (bench / "checks" / "big-still.json").write_text("{}")
    spec["configs"].append(dict(spec["configs"][0], name="gs2m-sparse-1080p",
                                file="benchmark/configs/gs2m-sparse-1080p.json"))
    spec["workloads"].append({"name": "big-view", "config": "gs2m-sparse-1080p",
                              "traffic": "fastview", "chips": 1, "why": "a test"})
    spec["workloads"].append({"name": "big-still", "config": "gs2m-sparse-1080p",
                              "traffic": "still", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "sparse-view" in m["workloads"]:
            m["workloads"].append("big-view")
    spec["per_layer"].append({"name": "untile_ms.view", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "composite",
                              "moves": "frame_ms_p50", "workloads": ["big-view"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("big-view", root=tmp_path)
    assert cell.config["n_gaussians"] == 2_000_000 and cell.traffic["sweep_frames"] == 60
    assert [m["name"] for m in cell.per_layer] == ["untile_ms.view"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "frame_ms_p50", "frame_ms_p95"}
    assert harness.load_cell("big-still", root=tmp_path).driver.run() is None


def test_reader_lookup():
    """A stage metric needs no file; `.train` and `.view` share a base's
    reader; a name with neither is refused."""
    run = harness.Reading(stages={"gather": [3.0, 1.0, 2.0]}, trace=None, traced_units=0,
                          unit_seconds=None, work=None, pixels=1, live=1, params_per_splat=59)
    assert harness.load_reader("gather_ms.view")(run) == 2.0
    assert harness.load_reader("sat_ms.train")(run) is None
    assert harness.load_reader("idle_share.view")(run) is None
    assert (harness.load_reader("k2_roofline.train").__code__.co_filename
            == harness.load_reader("k2_roofline.view").__code__.co_filename
            == str(harness.BENCH / "metrics" / "k2_roofline.py"))
    with pytest.raises(FileNotFoundError):
        harness.load_reader("no_such_metric.view")
