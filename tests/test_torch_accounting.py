"""``dibs_tpu_torch.accounting`` against ``dibs_tpu.accounting`` on the CPU.

* The step cost models carried over (``bge_step_cost``,
  ``linear_step_cost``, ``nonlinear_step_cost``) and the ring / all-gather
  traffic models equal the reference's at the configurations' shapes
  within 1e-12 relative (the same float arithmetic in the same order).
* ``roofline``, ``phase_roofline`` and ``multichip_projection`` on the
  ``"cpu_1core"`` peaks both packages share, with the link bandwidth and
  the per-round latency passed alike: equal key for key (NaN where NaN).
* ``kernel_cost`` + ``bound_ms`` give the bounds of ``PERF.md``'s kernel
  table at its printed rounding.
* ``torch_cost_analysis`` counts a matmul's FLOPs; the module's names are
  the reference's with ``xla_cost_analysis`` replaced.
"""
import math

import numpy as np
import pytest
import torch

import dibs_tpu.accounting as ref
import dibs_tpu_torch.accounting as port

torch.set_num_threads(1)

# (label, model, keyword arguments) at the configurations' shapes: the
# headline marginal, joint configs 2, 3 (both kernel routes), 4 and 5, and
# marginal config 6
STEP_CASES = [
    ("headline", "bge_step_cost",
     dict(d=20, n_obs=100, p=30, m=128, kmc=32, k=20)),
    ("config 2", "linear_step_cost",
     dict(d=20, n_obs=100, p=30, m=128, kmc=32, k=20)),
    ("config 3 fused", "nonlinear_step_cost",
     dict(d=20, n_obs=100, p=30, m=128, hidden=(5,), kmc=32, k=20,
          fused_kernel=True)),
    ("config 3 autodiff", "nonlinear_step_cost",
     dict(d=20, n_obs=100, p=30, m=128, hidden=(5,), kmc=32, k=20,
          fused_kernel=False)),
    ("config 4", "linear_step_cost",
     dict(d=30, n_obs=600, p=20, m=128, kmc=32, k=30)),
    ("config 5", "linear_step_cost",
     dict(d=128, n_obs=100, p=1000, m=32, kmc=8, k=128)),
    ("config 6", "bge_step_cost",
     dict(d=128, n_obs=100, p=100, m=64, kmc=8, k=128)),
]


def close(got, want, rel=1e-12):
    return abs(got - want) <= rel * max(abs(want), 1e-300)


def same(got, want):
    """Equal key for key; floats within 1e-12 relative, NaN where NaN."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), key
        elif isinstance(w, float):
            assert close(g, w), (key, g, w)
        else:
            assert g == w, (key, g, w)


@pytest.mark.parametrize("label,model,kw", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_step_cost_matches_reference(label, model, kw):
    got, want = getattr(port, model)(**kw), getattr(ref, model)(**kw)
    for field in ("flops", "bytes_min", "transcendentals"):
        assert close(getattr(got, field), getattr(want, field)), field
    assert got.phases.keys() == want.phases.keys()
    for phase, w in want.phases.items():
        assert close(got.phases[phase], w), phase


@pytest.mark.parametrize("model", ["ring_comm_model", "allgather_comm_model"])
@pytest.mark.parametrize("dtype_bytes", [4.0, 2.0])
def test_comm_models_match_reference(model, dtype_bytes):
    kw = dict(p=1000, n_dev=8, z_dim=32768, theta_dim=16384,
              dtype_bytes=dtype_bytes)
    same(getattr(port, model)(**kw), getattr(ref, model)(**kw))


@pytest.mark.parametrize("seconds", [0.044354, 0.000626, 1e-6])
def test_roofline_matches_reference_on_cpu_peaks(seconds):
    cost = port.linear_step_cost(d=128, n_obs=100, p=1000, m=32, kmc=8,
                                 k=128)
    for fp32 in (True, False):
        args = (cost.flops, cost.bytes_min, cost.transcendentals, seconds,
                "cpu_1core", fp32)
        same(port.roofline(*args), ref.roofline(*args))
    same(cost.total_row(seconds, "cpu_1core"),
         ref.linear_step_cost(d=128, n_obs=100, p=1000, m=32, kmc=8,
                              k=128).total_row(seconds, "cpu_1core"))


def test_phase_roofline_logic_matches_reference(monkeypatch):
    """The same rows from the same ceilings: both packages' tables replaced
    by one, then the phases whose ceilings agree unpatched (the reference
    falls back to the float32 peak for phases its table lacks)."""
    cost = port.nonlinear_step_cost(d=20, n_obs=100, p=30, m=128,
                                    fused_kernel=False)
    measured = {"forward": (0.5, ("soft_forward_plus_zvjp",)),
                "both": (1.25, ("soft_forward_plus_zvjp",
                                "hard_forward_plus_tvjp", "no such phase"))}
    same_rows = [port.phase_roofline(cost, measured, 20, "cpu_1core"),
                 ref.phase_roofline(cost, measured, 20, "cpu_1core")]
    for got, want in zip(*same_rows):
        same(got, want)

    table = {"soft_forward_plus_zvjp": 0.05, "hard_forward_plus_tvjp": 0.11,
             "sampling": 0.02, "acyclicity_prior": 0.09}
    monkeypatch.setattr(port, "PHASE_CEILINGS", lambda d, chip: table)
    monkeypatch.setattr(ref, "PHASE_CEILINGS", lambda d, chip: table)
    measured = {label: (0.3 + i, tuple(table)[:i + 1])
                for i, label in enumerate("abcd")}
    for got, want in zip(port.phase_roofline(cost, measured, 20, "cpu_1core"),
                         ref.phase_roofline(cost, measured, 20, "cpu_1core")):
        same(got, want)


@pytest.mark.parametrize("weak", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
@pytest.mark.parametrize("payload", [4.0, 2.0])
def test_multichip_projection_matches_reference(weak, n_dev, payload):
    kw = dict(seconds_1chip=0.05, p=1000, n_dev=n_dev, z_dim=32768,
              theta_dim=16384, transport_frac=0.36, t_fixed=0.002,
              weak=weak, chip="cpu_1core", round_latency_s=3e-5,
              payload_dtype_bytes=payload)
    same(port.multichip_projection(link_gbps=100.0, **kw),
         ref.multichip_projection(ici_gbps=100.0, **kw))


def test_multichip_limits():
    """``tests/test_parallel.py::test_multichip_comm_model``'s limit cases
    on the port, with the latency it requires passed."""
    p, n, zd, td = 1000, 8, 128 * 128 * 2, 128 * 128
    ring = port.ring_comm_model(p=p, n_dev=n, z_dim=zd, theta_dim=td)
    assert ring["block_bytes"] == 2 * (p / n) * (zd + td) * 4
    assert ring["rounds"] == n - 1
    assert ring["bytes_per_device"] == ring["block_bytes"] * (n - 1)
    ag = port.allgather_comm_model(p=p, n_dev=n, z_dim=zd, theta_dim=td)
    assert abs(ag["bytes_per_device"] - ring["bytes_per_device"]) < 1e-6

    # no fixed overhead, no exposure, no latency: 1/N
    proj = port.multichip_projection(
        seconds_1chip=0.05, p=p, n_dev=n, z_dim=zd, theta_dim=td,
        transport_frac=0.3, t_fixed=0.0, link_gbps=1e9, round_latency_s=0.0)
    assert abs(proj["t_step"] - 0.05 / n) < 1e-9
    assert abs(proj["efficiency"] - 1.0) < 1e-6
    # a per-round latency strictly reduces efficiency
    proj_lat = port.multichip_projection(
        seconds_1chip=0.05, p=p, n_dev=n, z_dim=zd, theta_dim=td,
        transport_frac=0.3, t_fixed=0.0, link_gbps=1e9,
        round_latency_s=1e-5)
    assert proj_lat["efficiency"] < proj["efficiency"]
    # a pure-fixed-overhead config cannot scale (the card's NVLink rate)
    proj2 = port.multichip_projection(
        seconds_1chip=0.001, p=30, n_dev=8, z_dim=20 * 20 * 2,
        transport_frac=0.05, t_fixed=0.001, round_latency_s=1e-5)
    assert proj2["efficiency"] <= 1.0 / 8 + 1e-6
    # weak scaling: per-card transport grows ~N, efficiency < 1
    w = port.multichip_projection(
        seconds_1chip=0.05, p=p, n_dev=n, z_dim=zd, theta_dim=td,
        transport_frac=0.36, t_fixed=0.0, weak=True, round_latency_s=1e-5)
    assert w["t_transport"] > 0.36 * 0.05 * (n - 1)
    assert 0.0 < w["efficiency"] < 1.0
    # no latency of the reference's chip is assumed
    with pytest.raises(TypeError, match="round_latency_s"):
        port.multichip_projection(seconds_1chip=0.05, p=p, n_dev=n,
                                  z_dim=zd, transport_frac=0.3)


def test_h100_peaks_and_ceilings():
    peaks = port.CHIP_PEAKS["h100_sxm"]
    assert (peaks["fp32_tflops"], peaks["bf16_tflops"], peaks["hbm_gbps"],
            peaks["link_gbps_dir"]) == (67.0, 989.4, 3350.0, 450.0)
    assert abs(peaks["sfu_gops"] - 4181.76) < 1e-9
    assert "tpu_v5e" not in port.CHIP_PEAKS
    assert port.CHIP_PEAKS["cpu_1core"] == ref.CHIP_PEAKS["cpu_1core"]
    ceils = port.PHASE_CEILINGS(128)
    # no MXU passes, no d/128 row scaling: the same ceilings at every d
    assert ceils == port.PHASE_CEILINGS(20)
    # sampling: 3 operations per SFU result, under the ALU's 33.5; every
    # other phase falls back to the float32 peak
    assert sorted(ceils) == ["in_kernel_sampling", "sampling",
                             "sampling_in_kernel"]
    for phase in ceils:
        assert abs(ceils[phase] - 3 * 4.18176) < 1e-12
    cost = port.linear_step_cost(d=128, n_obs=100, p=1000, m=32, kmc=8,
                                 k=128)
    rows = port.phase_roofline(cost, {
        "chain": (10.0, ("acyclicity_prior",)),
        "sampler": (1.0, ("sampling_in_kernel",))}, 128)
    assert [r["ceiling_tfs"] for r in rows] == [67.0, 12.5]
    row = port.linear_step_cost(d=128, n_obs=100, p=1000, m=32, kmc=8,
                                k=128).total_row(0.044354)
    assert 0.0 < row["transc_pct"] < 100.0
    assert 0.0 < row["mfu_pct"] < 100.0


def perf_gs(b, d, seed):
    """Random masks of density 0.3 without self-loops (the d=20 cell of
    ``chip_smoke.py``'s #2 case)."""
    rng = np.random.default_rng(seed)
    gs = (rng.uniform(size=(b, d, d)) < 0.3).astype(np.float32)
    gs[:, np.arange(d), np.arange(d)] = 0.0
    return torch.from_numpy(gs)


# (kernel, shape, the bound column's value as printed, its decimals, bound
# by): PERF.md's kernel table
BOUNDS = [
    ("gumbel_graphs", dict(p=30, m=128, d=20), "0.00185", "bytes"),
    ("gumbel_graphs", dict(p=1000, m=8, d=128), "0.17607", "bytes"),
    ("gumbel_graphs", dict(p=240, m=128, d=20), "0.01479", "bytes"),
    ("gumbel_graphs", dict(p=960, m=128, d=20), "0.05915", "bytes"),
    ("gumbel_graphs", dict(p=1000, m=4, d=128), "0.0978", "bytes"),
    ("bge_pairs", dict(gs=(3840, 20)), "0.00203", "bytes"),
    ("bge_pairs", dict(gs=(8 * 3840, 20), datasets=8), "0.01622", "bytes"),
    ("se_matrix", dict(a=30, n=800, triangle=True), "0.0000297", "bytes"),
    ("se_matrix", dict(a=1000, n=32768, triangle=True), "0.73435",
     "operations"),
    ("se_matrix", dict(a=1000, n=16384, triangle=True), "0.36717",
     "operations"),
    ("se_matrix", dict(a=1000, b=1000, n=32768), "1.467", "operations"),
    ("se_matrix", dict(a=1000, b=1000, n=16384), "0.7336", "operations"),
    ("se_matrix", dict(a=30, n=800, batch=8, triangle=True), "0.000238",
     "bytes"),
    ("se_matrix", dict(a=30, n=800, batch=32, triangle=True), "0.000951",
     "bytes"),
    ("transport_phi", dict(p=1000, n=32768, n_mats=2), "1.956",
     "operations"),
    ("transport_phi", dict(p=1000, n=16384, n_mats=2), "0.97815",
     "operations"),
    ("transport_phi", dict(p=30, n=800), "0.0000880", "bytes"),
    ("transport_phi", dict(p=30, n=2220, n_mats=2), "0.000243", "bytes"),
    ("transport_phi", dict(p=30, n=800, batch=8), "0.00070", "bytes"),
    ("transport_phi", dict(p=30, n=800, batch=32), "0.00282", "bytes"),
    ("fused_linear_single", dict(p=30, m=128, n=100, d=20), "0.01975",
     "operations"),
    ("fused_linear_single", dict(p=20, m=128, n=600, d=30), "0.17364",
     "operations"),
    ("fused_linear_single", dict(p=240, m=128, n=100, d=20, datasets=8),
     "0.15801", "operations"),
    ("fused_linear_pass1", dict(p=30, m=128, n=100, d=20), "0.01012",
     "operations"),
    ("fused_linear_pass1", dict(p=20, m=128, n=600, d=30), "0.08836",
     "operations"),
    ("fused_linear_pass1", dict(p=240, m=128, n=100, d=20, datasets=8),
     "0.08098", "operations"),
    ("fused_linear_wide_pass1", dict(p=1000, m=32, n=100, d=128), "3.228",
     "operations"),
    ("fused_linear_wide_pass1", dict(p=2000, m=32, n=100, d=128,
                                     datasets=2), "6.45579", "operations"),
    ("fused_linear_pass2", dict(p=30, m=128, n=100, d=20, replayed=56),
     "0.00031", "operations"),
    ("fused_linear_pass2", dict(p=20, m=128, n=600, d=30, replayed=33),
     "0.00249", "operations"),
    ("fused_linear_wide_pass2", dict(p=1000, m=32, n=100, d=128,
                                     replayed=1598), "0.3627", "operations"),
    ("fused_nonlinear", dict(p=30, m=128, n=100, d=20, h1=5), "0.09188",
     "operations"),
    ("fused_nonlinear", dict(p=20, m=128, n=600, d=30, h1=5), "0.8269",
     "operations"),
    ("fused_nonlinear", dict(p=240, m=128, n=100, d=20, h1=5, datasets=8),
     "0.73504", "operations"),
    ("acyclic_grad", dict(p=1000, d=128, k=8), "6.010", "operations"),
]


@pytest.mark.parametrize("kernel,shape,printed,by", BOUNDS,
                         ids=[f"{b[0]}-{b[2]}" for b in BOUNDS])
def test_kernel_bound_matches_perf_table(kernel, shape, printed, by):
    if "gs" in shape:
        shape = dict(shape, gs=perf_gs(*shape["gs"], seed=0))
    ms, bound_by = port.bound_ms(*port.kernel_cost(kernel, **shape))
    decimals = len(printed.split(".")[1])
    assert f"{ms:.{decimals}f}" == printed, ms
    assert bound_by == by


def test_kernel_cost_counts():
    """The counts behind the bounds: #2 over the actual parent counts, #9's
    12 products at d = 128, pass 2 replaying every pair by default, and
    the symmetric #3 call's one triangle."""
    gs = torch.zeros(2, 5, 5)
    gs[0, :3, 4] = 1.0  # node 4 of graph 0: 3 parents
    gs[1, 0, 1] = 1.0   # node 1 of graph 1: 1 parent
    flops, n_bytes = port.kernel_cost("bge_pairs", gs=gs)
    assert flops == 2 * (27 / 3 + 9) + 2 * (1 / 3 + 1)
    assert n_bytes == 4 * (5 ** 3 + 2 * (25 + 10))
    assert port.kernel_cost("acyclic_grad", p=1, d=128, k=1)[0] == (
        2 * 128 ** 3 * 12)
    shape = dict(p=3, m=5, n=7, d=4)
    assert (port.kernel_cost("fused_linear_pass2", **shape)
            == port.kernel_cost("fused_linear_pass2", replayed=15, **shape))
    assert port.kernel_cost("fused_linear_wide_pass1", **shape) == (
        port.kernel_cost("fused_linear_pass1", **shape))
    assert port.kernel_cost("se_matrix", a=4, n=10, triangle=True)[0] == (
        3 * 10 * 10)
    with pytest.raises(KeyError, match="no_such_kernel"):
        port.kernel_cost("no_such_kernel", p=1)
    with pytest.raises(TypeError):
        port.kernel_cost("gumbel_graphs", p=1, m=1)


def test_kernel_cost_names_are_the_launch_counters():
    from dibs_tpu_torch.ops.gpu_kernels import LAUNCHES

    for name in LAUNCHES:
        shape = {"bge_pairs": dict(gs=torch.ones(1, 3, 3)),
                 "se_matrix": dict(a=2, n=3),
                 "transport_phi": dict(p=2, n=3),
                 "fused_nonlinear": dict(p=2, m=2, n=3, d=3, h1=2),
                 "acyclic_grad": dict(p=2, d=3, k=2),
                 "score_ratio": dict(p=2, m=2, d=3),
                 "gumbel_graphs": dict(p=2, m=2, d=3)}.get(
                     name, dict(p=2, m=2, n=3, d=3))
        flops, n_bytes = port.kernel_cost(name, **shape)
        assert flops > 0 and n_bytes > 0, name


def test_torch_cost_analysis():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    got = port.torch_cost_analysis(torch.matmul, a, b)
    assert got["flops"] == 65536.0
    assert math.isnan(got["bytes_accessed"])
    assert math.isnan(got["transcendentals"])
    assert port.torch_cost_analysis(torch.matmul, a, a) is None


def test_all_matches_reference():
    want = [n for n in ref.__all__ if n != "xla_cost_analysis"]
    assert sorted(port.__all__) == sorted(
        want + ["torch_cost_analysis", "kernel_cost", "bound_ms"])
    for name in port.__all__:
        assert hasattr(port, name), name
