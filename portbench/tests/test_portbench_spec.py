"""The harness finds every configuration, cell and per-layer metric by
name, and a cell added as new files runs without an edit to a file the
benchmark has."""
import json
import shutil

import pytest

from portbench import harness, spec
from portbench.tests.conftest import CELLS, tiny


def _bench():
    return json.loads((spec.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in _bench()["workloads"] if w["name"] == name)
    assert spec.load_system(cell.config["system"]).build
    assert spec.load_reference(cell.config["reference"]).Reference
    assert {"warm_steps", "segment_steps"} <= set(cell.traffic)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "steps_per_s"}
    assert cell.per_layer


def test_every_metric_has_a_reader():
    bench = _bench()
    for m in bench["per_layer"]:
        assert callable(spec.load_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", [])) <= {w["name"]
                                              for w in bench["workloads"]}


def test_every_config_file_is_one_configs():
    bench = _bench()
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        outputs = ["dz", "dtheta"] if "theta" in body["compare"] else ["dz"]
        assert set(body["limits"]) == {f"{state}_{q}_{leaf}"
                                       for leaf in body["compare"]
                                       for state in ("start", "end")
                                       for q in ("p50", "p90", "over")} | {
            f"lik_{q}_{o}" for o in outputs
            for q in ("p50", "p90", "over")} | {"replay"}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")


def test_cell_added_as_files(tmp_path):
    """A new traffic mix, a new configuration, a new metric and a new cell
    are files and entries only; the copy of the benchmark then runs it."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((tmp_path / "portbench/configs/joint_linear_sf128.json")
                     .read_text())
    cfg.update(name="joint_linear_er12", graph_prior="er", n_vars=12,
               latent_dim=12, n_particles=6, n_observations=30,
               n_grad_mc_samples=8, n_acyclicity_mc_samples=4,
               reference_options={})
    (tmp_path / "portbench/configs/joint_linear_er12.json").write_text(
        json.dumps(cfg))
    (tmp_path / "portbench/traffic/short.json").write_text(json.dumps(
        {"warm_steps": 1, "segment_steps": 2, "who": "test"}))
    (tmp_path / "portbench/metrics/steps_in_trace.py").write_text(
        "def read(trace, cell):\n    return float(trace.steps)\n")
    bench["configs"].append({"name": "joint_linear_er12", "source": "x",
                             "file": "portbench/configs/joint_linear_er12.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "joint_linear_er12.short",
                               "config": "joint_linear_er12",
                               "traffic": "short", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "steps_in_trace", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "engine", "moves": "steps_per_s",
                               "workloads": ["joint_linear_er12.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("joint_linear_er12.short", root=tmp_path)
    assert "steps_in_trace" in [m["name"] for m in cell.per_layer]
    line, *_ = harness.run_cell(cell, 7, 0.0, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"]["steps_in_trace"]["value"] == 2.0
    for path, body in before.items():
        assert path.read_bytes() == body, f"{path} changed"


@pytest.mark.parametrize("name", CELLS)
def test_tiny_cell_runs_both_modes(name):
    cell = tiny(spec.load_cell(name))
    plain, *_ = harness.run_cell(cell, 2 ** 31 + 5, 0.2, False, "cpu")
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(plain)[-1] == "checks"
    traced, *_ = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True, "cpu")
    assert traced["correct"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
