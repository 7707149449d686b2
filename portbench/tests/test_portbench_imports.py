"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``dibs_tpu_torch`` is not ``dibs_tpu``), the
reference imports nothing of the program, and a run without the card, or
without the program, prints no result."""
import shutil
import subprocess
import sys
import types

import pytest

from portbench import harness, spec
from portbench.tests.conftest import ROOT, tiny

_RUN_ALL = """
import sys
sys.path.insert(0, {root!r})
import importlib, pathlib
from portbench import calibrate, compare, datagen, harness, layers, spec, trace, workcount
import portbench.systems.dibs_engine
for p in sorted(pathlib.Path({root!r}, "portbench", "reference").glob("*.py")):
    importlib.import_module("portbench.reference." + p.stem)
from portbench.tests.conftest import tiny
for name in ("joint_linear_sf128.single", "marginal_bge_sf128.dense"):
    cell = tiny(spec.load_cell(name))
    for m in cell.per_layer:
        spec.load_reader(m["name"])
    assert harness.run_cell(cell, 3, 0.0, True, "cpu")[0]["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""

_REFERENCE_ONLY = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from portbench.reference import common, joint_linear, marginal_bge
cfg = dict(n_vars=6, latent_dim=6, n_particles=3, n_grad_mc_samples=4,
           n_acyclicity_mc_samples=2, tau=1.0, alpha_linear=0.5,
           beta_linear=1.0, obs_noise=0.1, mean_edge=0.0, sig_edge=1.0,
           min_edge=0.5, graph_prior="sf", edges_per_node=2, h_latent=5.0,
           h_theta=500.0, stepsize=0.005, bge_alpha_mu=1.0, bge_alpha_lambd=8.0,
           fixed_seed=5)
x = np.random.default_rng(0).standard_normal((10, 6)).astype("float32")
for mod in (joint_linear, marginal_bge):
    ref = mod.Reference(cfg, x, common.REFERENCE, "cpu")
    ref.step(ref.step(ref.init_state(1), 1), 1)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_no_jax_in_a_run():
    mods = _modules(_RUN_ALL)
    assert "dibs_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    mods = _modules(_REFERENCE_ONLY)
    assert not mods & {"dibs_tpu_torch", *harness.FORBIDDEN}


def test_a_loaded_jax_module_fails_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell(tiny(spec.load_cell("joint_linear_sf128.single")),
                         1, 0.0, False, "cpu")


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "joint_linear_sf128.single", "--seed", "2147483700", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(cwd))


def test_no_result_without_the_card():
    out = _run(ROOT)
    if out.returncode == 0:
        pytest.skip("a card is present")
    assert out.stdout == ""
    assert "CUDA device" in out.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
