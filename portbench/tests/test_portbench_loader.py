"""The harness finds every cell, configuration and metric by name, and a
cell added as files and entries only (in a temporary copy of the
benchmark) runs with no edit to a file already there."""
import json
import os
import re
import shutil


from portbench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_file():
    spec = bench.spec()
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(bench.ROOT, c["file"]))
        assert bench.config_file(c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        cell = bench.cell_file(w["name"])
        assert cell["config"] == w["config"]
        assert bench.runner_module(cell["runner"]).run
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))


def test_spec_keeps_the_contract():
    spec = bench.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(bench.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= cells if "workloads" in m else True
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # the cell reports what the metric moves
            mv = e2e[m["moves"]]
            assert "workloads" not in mv or w in mv["workloads"]
    for w in spec["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        reported = [m for m in spec["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
    for c in spec["configs"]:
        assert c["file"].startswith("portbench/") and c["reduced"] == []


def test_a_cell_added_as_files_only(tmp_path):
    """Copy BENCHMARK.json and portbench/, add a configuration, a cell (the
    reference's moving dot with SloMo off, the CLI's direct path) and a
    metric as new files and entries, and run the new cell on the CPU."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(bench.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(os.path.join(root, "portbench", p), "rb").read()
              for p in ("cells/dvs346_slomo_u10.json", "runners/convert.py", "bench.py")}
    cfg = bench.config_file("superslomo_dvs346")
    cfg.update(name="dvs240_small", width=240, height=180)
    (root / "portbench/configs/dvs240_small.json").write_text(json.dumps(cfg))
    cell = {"runner": "convert", "config": "dvs240_small", "slomo": False, "chunk_frames": 16,
            "source": {"kind": "moving_dot", "dt": 0.0001, "radius": 40.0, "speed_pps": 1000.0,
                       "num_dots": 5, "contrast": 10.0, "bg": 5.0, "bg_spread": 2},
            "check": {"check_every": 1, "limits": {"events_mismatch": 0.03, "state_mismatch": 0.01}}}
    (root / "portbench/cells/dvs240_dot_small.json").write_text(json.dumps(cell))
    (root / "portbench/metrics/events_per_chunk.py").write_text(
        "def read(run):\n    return run.counts['events_written'] / run.counts['chunks']\n")
    spec = bench.spec()
    spec["configs"].append({"name": "dvs240_small", "source": "https://github.com/SensorsINI/v2e",
                            "file": "portbench/configs/dvs240_small.json", "reduced": [],
                            "why": "a small stand-in"})
    spec["workloads"].append({"name": "dvs240_dot_small", "config": "dvs240_small",
                              "traffic": "dot_small", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "realtime_x":
            m["workloads"].append("dvs240_dot_small")
    spec["per_layer"].append({"name": "events_per_chunk", "unit": "events", "better": "higher",
                              "source": "program_counter", "layer": "host events and sinks",
                              "moves": "realtime_x", "workloads": ["dvs240_dot_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    run = bench.run_cell("dvs240_dot_small", 12345, 2.0, False, "cpu", root=str(root))
    line = bench.result_line(run, bench.spec(str(root)), root=str(root))
    assert line["correct"] and set(line["metrics"]) == {"realtime_x", "setup_s"}
    run.trace = True
    traced = bench.result_line(run, bench.spec(str(root)), root=str(root))
    assert "events_per_chunk" in traced["metrics"]
    for p, data in before.items():
        assert open(os.path.join(root, "portbench", p), "rb").read() == data
