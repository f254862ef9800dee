"""The port's chip model, GPU planner, `quantize_tree` and design-space
twin against the JAX package's, on the CPU.

* `repro_torch.core.chip` is a copy of COIN's crossbar/CE capacity model:
  `chips_required` equals the reference's for every Table I dataset in both
  modes (the paper's Cora 1, Citeseer 1 and Nell 45; Pubmed's 3.09
  cell-granular chips, which the paper rounds down to 3 and the model up to
  4), and so do `ChipModel`'s properties.
* `repro_torch.core.planner` keeps the reference's formulas with the H100's
  rates: given the reference's TPU values (same fields), every term and
  every chosen plan equals the reference's; under its own defaults the
  planner is never worse than the two extremes.
* `quantize_tree` on a GCN parameter tree equals the reference's, leaf by
  leaf, with and without ``percentile``.
* `repro_torch.launch.coin_design_space` prints the reference example's
  chip-scale lines character for character, and all its lines under the
  reference's rates.
"""
import contextlib
import dataclasses
import io
import pathlib
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import chip as rchip
from repro.core import planner as rplan
from repro.core.quant import quantize_tree as r_quantize_tree
from repro.graph.generators import TABLE_I as R_TABLE_I
from repro_torch.core import chip as tchip
from repro_torch.core import planner as tplan
from repro_torch.core.quant import fake_quant, quantize_tree
from repro_torch.graph.generators import TABLE_I
from repro_torch.launch import coin_design_space

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The paper's counts (§V-C); Pubmed's 3 is 3.09 chips of cells rounded down, which the model
# (and the reference's) rounds up.
PAPER_CHIPS = {("cora", "crossbar"): 1, ("citeseer", "crossbar"): 1, ("pubmed", "cell"): 4,
               ("nell", "crossbar"): 45}


def _dims(spec):
    return [spec.n_features, 16, spec.n_labels]


def _ref_hw() -> tplan.GPUHardware:
    return tplan.GPUHardware(**dataclasses.asdict(rplan.TPUHardware()))


# ------------------------------------------------------------------ chip
@pytest.mark.parametrize("mode", ["crossbar", "cell"])
@pytest.mark.parametrize("name", sorted(TABLE_I))
def test_chips_required_equal_reference(name, mode):
    spec, rspec = TABLE_I[name], R_TABLE_I[name]
    assert (spec.n_nodes, spec.n_features, spec.n_labels) == (rspec.n_nodes, rspec.n_features, rspec.n_labels)
    got = tchip.chips_required(tchip.ChipModel(), spec.n_nodes, _dims(spec), mode=mode)
    assert got == rchip.chips_required(rchip.ChipModel(), rspec.n_nodes, _dims(rspec), mode=mode)
    if (name, mode) in PAPER_CHIPS:
        assert got == PAPER_CHIPS[name, mode]


@settings(max_examples=25, deadline=None)
@given(n=st.lists(st.integers(1, 200_000), min_size=2, max_size=6),
       d_in=st.integers(1, 4096), d_out=st.integers(1, 256), mode=st.sampled_from(["crossbar", "cell"]))
def test_chips_required_monotone_in_nodes(n, d_in, d_out, mode):
    cm, dims = tchip.ChipModel(), [d_in, 16, d_out]
    counts = [tchip.chips_required(cm, x, dims, mode=mode) for x in sorted(n)]
    assert counts == sorted(counts)
    assert counts == [rchip.chips_required(rchip.ChipModel(), x, dims, mode=mode) for x in sorted(n)]


def test_chip_model_properties_equal_reference():
    cm, rm = tchip.ChipModel(), rchip.ChipModel()
    assert dataclasses.asdict(cm) == dataclasses.asdict(rm)
    assert (cm.cells_per_pe, cm.cells_per_chip, cm.bytes_per_chip) == (
        rm.cells_per_pe, rm.cells_per_chip, rm.bytes_per_chip)
    assert abs(cm.bytes_per_chip - 30 * 2**20) / (30 * 2**20) < 0.01        # the 30 MB chip (§IV-B3)
    for spec in TABLE_I.values():
        assert cm.weight_crossbars(_dims(spec)) == rm.weight_crossbars(_dims(spec))
        assert cm.adjacency_crossbars_total(spec.n_nodes) == rm.adjacency_crossbars_total(spec.n_nodes)
        assert cm.adjacency_budget_per_ce(_dims(spec)) == rm.adjacency_budget_per_ce(_dims(spec))
    with pytest.raises(ValueError, match="weights alone overflow"):
        tchip.chips_required(cm, 1000, [128 * 512, 128 * 512])


# --------------------------------------------------------------- planner
def test_gpu_hardware_fields_are_the_references_and_defaults_the_h100s():
    assert [f.name for f in dataclasses.fields(tplan.GPUHardware)] == [
        f.name for f in dataclasses.fields(rplan.TPUHardware)]
    assert [f.name for f in dataclasses.fields(tplan.GPUPlan)] == [f.name for f in dataclasses.fields(rplan.TPUPlan)]
    hw = tplan.GPUHardware()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.bytes_per_elt) == (67e12, 3.35e12, 450e9, 4.0)
    assert dataclasses.asdict(hw) != dataclasses.asdict(rplan.TPUHardware())


@settings(max_examples=30, deadline=None)
@given(n=st.integers(1000, 3_000_000), e=st.integers(1000, 50_000_000),
       devices=st.sampled_from([1, 6, 16, 64, 256, 512]), schedule=st.sampled_from(["broadcast", "halo"]),
       cut=st.one_of(st.none(), st.floats(0.0, 1.0)))
def test_objective_and_plan_equal_reference_under_its_rates(n, e, devices, schedule, cut):
    dims = [128, 16, 8]
    for k in (1, devices):
        assert tplan.coin_objective_gpu(n, e, dims, k, _ref_hw(), schedule, cut) == rplan.coin_objective_tpu(
            n, e, dims, k, rplan.TPUHardware(), schedule, cut)
    got = tplan.plan_gnn_sharding(n, e, dims, devices, _ref_hw(), schedule, cut)
    ref = rplan.plan_gnn_sharding(n, e, dims, devices, rplan.TPUHardware(), schedule, cut)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.dominant == ref.dominant
    assert tplan._divisors(devices) == rplan._divisors(devices)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1000, 3_000_000), e=st.integers(1000, 50_000_000),
       devices=st.sampled_from([8, 16, 64, 256, 512]))
def test_planner_never_worse_than_extremes_h100(n, e, devices):
    """Twin of tests/test_planner_scheduler.py::test_planner_never_worse_than_extremes
    under the H100's rates: the search over all divisors beats k = 1 and k = devices."""
    dims = [128, 16, 8]
    best = tplan.plan_gnn_sharding(n, e, dims, devices)
    for k in (1, devices):
        comp, intra, inter = tplan.coin_objective_gpu(n, e, dims, k)
        assert best.est_step_s <= max(comp, intra) + inter + 1e-12


def test_planner_halo_beats_broadcast_on_low_cut_h100():
    spec = dict(n_nodes=1_000_000, n_edges=20_000_000, feat_dims=[256, 64, 16])
    bc = tplan.plan_gnn_sharding(**spec, n_devices=256, schedule="broadcast")
    halo = tplan.plan_gnn_sharding(**spec, n_devices=256, schedule="halo", cut_fraction=0.1)
    assert halo.est_step_s < bc.est_step_s
    with pytest.raises(ValueError):
        tplan.coin_objective_gpu(1000, 1000, [4, 4], 2, schedule="ring")


# ---------------------------------------------------------- quantize_tree
def _gcn_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tree = {f"w{i}": rng.standard_normal((a, b)).astype(np.float32) for i, (a, b) in enumerate([(24, 16), (16, 7)])}
    tree.update({f"b{i}": rng.standard_normal(b).astype(np.float32) for i, b in enumerate([16, 7])})
    tree["w0"][3, 5] = 40.0                   # one outlier: percentile and amax calibrations differ
    return tree


@pytest.mark.parametrize("percentile", [None, 99.0])
@pytest.mark.parametrize("bits", [2, 4, 8, 32])
def test_quantize_tree_equals_reference(bits, percentile):
    tree = _gcn_tree(bits)
    ref = r_quantize_tree({**{k: jnp.asarray(v) for k, v in tree.items()}, "n": 3, "ids": jnp.arange(4)}, bits,
                          percentile=percentile)
    got = quantize_tree({**{k: torch.from_numpy(v) for k, v in tree.items()}, "n": 3,
                         "ids": torch.arange(4), "nested": [(torch.from_numpy(tree["b0"]), None)]},
                        bits, percentile=percentile)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["n"] == 3 and torch.equal(got["ids"], torch.arange(4))            # integer leaves untouched
    np.testing.assert_array_equal(got["nested"][0][0].numpy(), np.asarray(ref["b0"]))
    assert got["nested"][0][1] is None
    if bits < 32 and percentile is not None:
        assert not np.array_equal(got["w0"].numpy(), quantize_tree({"w0": torch.from_numpy(tree["w0"])}, bits)["w0"])
        np.testing.assert_array_equal(got["w0"].numpy(),
                                      fake_quant(torch.from_numpy(tree["w0"]), bits, percentile=percentile).numpy())


def test_quantize_tree_keeps_the_straight_through_gradient():
    w = torch.from_numpy(_gcn_tree(0)["w1"]).requires_grad_()
    quantize_tree({"w": w}, 4)["w"].sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))


# ---------------------------------------------------------- design space
def _stdout(fn, *args, **kw) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return buf.getvalue().splitlines()


def test_design_space_chip_scale_lines_equal_reference_example():
    ref_main = runpy.run_path(str(ROOT / "examples" / "coin_design_space.py"), run_name="example")["main"]
    ref = _stdout(ref_main)
    got = _stdout(coin_design_space.main)
    split = ref.index("== pod scale: model-parallel degree via the same objective ==")
    assert got[:split] == ref[:split]
    assert len([line for line in got[:split] if "best=" in line]) == len(TABLE_I)
    assert len(got) == len(ref) and got[split] == ref[split]
    assert _stdout(coin_design_space.main, hw=_ref_hw()) == ref          # the pod lines too, at the reference's rates
