"""The port's hillclimb (`repro_torch.launch.hillclimb`) against the
reference's `repro.launch.hillclimb`.

* One JAX subprocess (4 host devices, a (1, 4) mesh of Auto axes; its
  device count is fixed before the reference module's import asks for
  512; its cwd a temporary directory, since target 3 writes its plan
  there) runs the reference's four targets with ``_measure``,
  ``make_production_mesh`` and ``get_arch`` patched: REDUCED configs at
  small shapes (`tests/_torch_hillclimb_ranks.py`), every cell captured.
  It then runs the reference's three hand-built cells on the port's
  seeded inputs: ``_pna_halo_cell`` in fp32, bf16 compute, bf16 wire,
  float64, and float64 over a bf16 wire, on the k = 1 and k = 4 plans, t2-b's accumulation step, and
  both ``_gemma_twostack_cell`` variants at two positions.
* The port's cells on one process (a 1 × 1 grid) and on one 4-rank gloo
  group (1 × 4) against them: losses, gradients (the first AdamW moment
  / (1 − b1)), logits and the written caches, at the parity contract's
  tolerances (fp32 2e-4, bf16 5e-2; PNA's gradient in float64, as
  tests/test_torch_gnn_models.py holds it: its fp32 std is
  ill-conditioned). The lockstep loss that `chip_smoke.py` holds the
  4-rank PNA step against equals the reference's k = 4 cell.
* The port's ``main`` on the same small configurations and a 1 × 4 grid:
  the reference's tags in its order, its record keys, ``model_flops``
  equal to the reference cells', each baseline equal to `run_cell`'s
  record of the same cell, t3-a above t3-baseline in collective bytes,
  t2-a below t2-baseline in peak bytes, t2-c equal to t2-a, t3-c's wire
  half of the fp32 cell's, and a second ``--target`` merged into the file.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_hillclimb_ranks as hr
from repro_torch.configs import registry
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import hillclimb as hc
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import GroupSpec, Grid, fake_group, run_group
from repro_torch.launch.shardings import shard_slices

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRID4 = Grid(("data", "model"), (1, 4))
GRID1 = Grid(("data", "model"), (1, 1))
REF_KEYS = {"tag", "compute_s", "memory_s", "collective_s", "collective_by_type", "peak_bytes", "compile_s",
            "model_flops"}
F32, BF16 = 2e-4, 5e-2

_REF_SCRIPT = r"""
import os, sys, pickle, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
result, sys.stdout = sys.stdout.buffer, sys.stderr     # the targets print; the result goes out alone
import jax
jax.devices()                       # 4 devices, before the reference module appends its 512
import numpy as np
import jax.numpy as jnp
import repro.configs
import repro.launch.mesh
from repro.configs import ShapeSpec
from repro.configs import get_arch as real_get_arch
import repro.launch.hillclimb as hc
from repro.launch.steps import _shape_halo_plan
from repro.train.optimizer import adamw

cuts, lm_shapes, pna_shape, inputs = pickle.load(open(sys.argv[2], "rb"))
axes = (jax.sharding.AxisType.Auto,) * 2
mesh4 = jax.make_mesh((1, 4), ("data", "model"), axis_types=axes)
mesh1 = jax.make_mesh((1, 1), ("data", "model"), axis_types=axes, devices=jax.devices()[:1])

def get_arch(arch):
    spec = real_get_arch(arch)
    if arch in cuts:
        cfg = dataclasses.replace(spec.make_reduced(), **cuts[arch])
        shapes = {name: ShapeSpec(name, **kw) for name, kw in lm_shapes.items()}
        return dataclasses.replace(spec, make_config=lambda shape=None, c=cfg: c, shapes=shapes)
    return dataclasses.replace(spec, shapes=dict(spec.shapes, ogb_products=ShapeSpec("ogb_products", "graph",
                                                                                      **pna_shape)))

cells = {}
def measure(cell, mesh, tag):
    cells[tag] = cell
    return {"tag": tag, "model_flops": cell.model_flops}

repro.configs.get_arch = get_arch
repro.launch.mesh.make_production_mesh = lambda multi_pod=False: mesh4
hc._measure = measure
records = {t.__name__: t() for t in (hc.target1_moe, hc.target2_granite, hc.target3_pna, hc.target4_gemma_cache)}
out = {"records": records}

def grads(o):
    return jax.tree_util.tree_map(lambda m: np.asarray(m.astype(jnp.float32)) / 0.1, o["m"])

# PNA's halo cell: fp32, bf16 compute, bf16 wire on the k = 1 and k = 4 plans; float64 under x64.
spec = get_arch("pna")
shape = spec.shapes["ogb_products"]
cfg = spec.make_config(shape)
for k, mesh in ((1, mesh1), (4, mesh4)):
    plan = _shape_halo_plan(shape.n_nodes, shape.n_edges, k)
    params, batch = inputs["pna"][k]
    for mode, kw, x64 in (("fp32", {}, False), ("bf16_compute", {"compute_dtype": jnp.bfloat16}, False),
                          ("bf16_wire", {"payload": "bf16"}, False), ("float64", {"compute_dtype": jnp.float64}, True),
                          ("float64_bf16_wire", {"compute_dtype": jnp.float64, "payload": "bf16"}, True)):
        with jax.enable_x64(x64):
            dt = jnp.float64 if x64 else jnp.float32
            cell = hc._pna_halo_cell(mesh, plan, cfg, shape, **kw)
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), params)
            b = {n: jnp.asarray(a, dt if a.dtype.kind == "f" else jnp.int32) for n, a in batch.items()}
            o = adamw(1e-3).init(p)
            with mesh:
                _, o, loss = jax.jit(cell.fn)(p, o, b)
            out[f"pna/{mode}/{k}"] = dict(loss=float(loss), grads=grads(o))

# t2-b: the captured accumulation cell on the port's bf16 parameters and tokens.
params, tokens = inputs["granite"]
p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
with mesh4:
    _, o, loss = jax.jit(cells["t2-b remat + 8x microbatch"].fn)(p, adamw(3e-4).init(p), jnp.asarray(tokens, jnp.int32))
out["granite"] = dict(loss=float(loss), grads=grads(o))

# Both two-stack decodes, at each position.
spec = get_arch("gemma3-12b")
for (ring, pos), (params, cache, token) in inputs["gemma"].items():
    cell = hc._gemma_twostack_cell(mesh4, spec, spec.shapes["long_500k"], ring=ring)
    bf = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), t)
    with mesh4:
        logits, new = jax.jit(cell.fn)(bf(params), bf(cache), jnp.asarray(token, jnp.int32), jnp.int32(pos))
    out[f"gemma/{ring}/{pos}"] = dict(logits=np.asarray(logits),
                                      cache={n: np.asarray(v.astype(jnp.float32)) for n, v in new.items()})
result.write(pickle.dumps(out))
"""


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _port_inputs() -> dict:
    """The port's seeded inputs of every hand-built cell, whole (a 1 × 1
    grid), as numpy for the reference: PNA's per k stacked over the plan's
    blocks."""
    from repro_torch.launch.steps import _gnn_params, draw_tree

    out = {"pna": {}, "gemma": {}}
    spec = hr.small_spec("pna")
    shape = spec.shapes["ogb_products"]
    cfg = spec.make_config(shape)
    for k in (1, 4):
        plan = hr.pna_cell(Grid(("data", "model"), (1, k)), "fp32").halo_plan
        params = hr.host(draw_tree(hr.SEED, _gnn_params("pna", cfg), torch.float32, "cpu"))
        blocks = [hc.pna_halo_batch(plan, cfg, shape, hr.SEED, r, "cpu") for r in range(k)]
        out["pna"][k] = (params, {n: np.stack([b[n].numpy() for b in blocks]) for n in blocks[0]})
    with fake_group(GRID1):
        params, _, tokens = hr.granite_cell(GRID1).bind().make_inputs(hr.SEED, "cpu")
        out["granite"] = (hr.host(params), tokens.numpy())
        for ring in (False, True):
            for pos in hr.POS:
                params, cache, token, _ = hr.gemma_cell(GRID1, ring, pos).bind().make_inputs(hr.SEED, "cpu")
                out["gemma"][ring, pos] = (hr.host(params), hr.host(cache), token.numpy())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the 4-rank group, started side by side;
    then the port's cells on one process."""
    tmp = tmp_path_factory.mktemp("hillclimb_ref")
    arg = tmp / "inputs.pkl"
    arg.write_bytes(pickle.dumps((hr.LM_CUTS, hr.LM_SHAPES, hr.PNA_SHAPE, _port_inputs())))
    ref = subprocess.Popen([sys.executable, "-c", _REF_SCRIPT, os.path.abspath(SRC), str(arg)], cwd=tmp,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        group = run_group(GroupSpec(k=4, timeout_s=600.0), hr.hill_rank, [GRID4] * 4)
        with fake_group(GRID1):
            local = hr.hill_rank(0, 1, torch.device("cpu"), GRID1)
        out, err = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err.decode()[-3000:]
    return pickle.loads(out), local, group


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / scale
    assert err <= rtol, (what, err)


def _rank_slice(want: np.ndarray, spec, coords):
    return want[shard_slices(want.shape, spec, coords)]


@pytest.mark.parametrize("mode", list(hr.PNA_MODES))
@pytest.mark.parametrize("k", [1, 4])
def test_pna_halo_cell_matches_reference(runs, k, mode):
    ref, local, group = runs
    want = ref[f"pna/{mode}/{k}"]
    tol = BF16 if "bf16" in mode else F32
    for got in ([local[f"pna/{mode}"]] if k == 1 else [res[f"pna/{mode}"] for res in group]):
        assert abs(got["loss"] - want["loss"]) <= tol * abs(want["loss"]), (mode, got["loss"], want["loss"])
        if mode.startswith("float64"):   # fp32's std gradient is ill-conditioned (queue 3): held in float64
            g = _leaves(got["grads"])
            for name, v in _leaves(want["grads"]).items():
                _close(g[name], v, tol, f"pna/{mode}/{k}{name}")


def test_pna_lockstep_matches_reference_k4(runs):
    """`pna_halo_lockstep_loss` (the k blocks in one process) is the k = 4
    cell's function: its loss and gradient equal the reference's in float64."""
    from repro_torch.launch.steps import _gnn_params, draw_tree
    from repro_torch.train.loop import value_and_grad

    ref, _, _ = runs
    spec = hr.small_spec("pna")
    shape = spec.shapes["ogb_products"]
    cfg = spec.make_config(shape)
    plan = hr.pna_cell(GRID4, "fp32").halo_plan
    params = draw_tree(hr.SEED, _gnn_params("pna", cfg), torch.float32, "cpu")
    blocks = [hc.pna_halo_batch(plan, cfg, shape, hr.SEED, r, "cpu") for r in range(4)]
    loss, grads = value_and_grad(lambda p, b: hc.pna_halo_lockstep_loss(p, b, cfg, torch.float64), params, blocks)
    want = ref["pna/float64/4"]
    assert abs(float(loss) - want["loss"]) <= 1e-6 * abs(want["loss"])
    g = _leaves(hr.host(grads))
    for name, v in _leaves(want["grads"]).items():
        _close(g[name], v, 1e-5, name)
    # A k = 1 plan computes another function: padding rows and edges enter the reference's cell.
    assert abs(ref["pna/float64/1"]["loss"] - want["loss"]) > 1e-6 * abs(want["loss"])


def test_granite_accumulation_matches_reference(runs):
    ref, local, group = runs
    want = ref["granite"]
    cell = hr.granite_cell(GRID4)
    for got, specs in [(local["granite"], None)] + [(res["granite"], cell.param_specs) for res in group]:
        assert abs(got["loss"] - want["loss"]) <= BF16 * abs(want["loss"])
        g, s = _leaves(got["grads"]), _leaves(specs) if specs else None
        for name, v in _leaves(want["grads"]).items():
            v = v if s is None else _rank_slice(v, s[name], got["coords"])
            _close(g[name], v, BF16, f"granite{name}")


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", hr.POS)
def test_gemma_twostack_matches_reference(runs, ring, pos):
    ref, local, group = runs
    want = ref[f"gemma/{ring}/{pos}"]
    seq = (None, None, ("data", "model"), None, None)
    specs = {"k": seq, "v": seq, "rk": (None,) * 6, "rv": (None,) * 6}
    for got, sharded in [(local[f"gemma/{ring}/{pos}"], False)] + [(res[f"gemma/{ring}/{pos}"], True)
                                                                   for res in group]:
        logits = want["logits"] if not sharded else _rank_slice(want["logits"], (None, "model"), got["coords"])
        _close(got["logits"], logits, BF16, f"logits {ring} {pos}")
        if not sharded:
            assert np.argmax(got["logits"], -1).tolist() == np.argmax(want["logits"], -1).tolist()
        assert set(got["cache"]) == set(want["cache"])
        for name, v in want["cache"].items():
            v = _rank_slice(v, specs[name], got["coords"]) if sharded else v
            _close(got["cache"][name], v, BF16, f"cache {name} {ring} {pos}")


# ----------------------------------------------------------------- the records
@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hillclimb_port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "get_arch", hr.small_spec)
        mp.setattr(tmesh, "production_grid", lambda multi_pod=False: GRID4)
        mp.chdir(tmp)
        out = str(tmp / "hc.json")
        assert hc.main(["--target", "all", "--out", out]) == 0
        records = json.load(open(out))
        base = {arch: tdr.run_cell(arch, shape, False, verbose=False, grid=GRID4)
                for arch, shape in (("moonshot-v1-16b-a3b", "train_4k"), ("granite-34b", "train_4k"),
                                    ("pna", "ogb_products"), ("gemma3-12b", "long_500k"))}
        spec = hr.small_spec("pna")
        shape = spec.shapes["ogb_products"]
        plan = hr.pna_cell(GRID4, "fp32").halo_plan
        fp32 = hc._measure(hc._pna_halo_cell(GRID4, plan, spec.make_config(shape), shape), GRID4, "fp32")
        assert os.path.exists(tmp / hc.PLAN_PATH) and not os.path.exists(tmp / "results/halo_plan_ogb.npz")
        # a second --target merges into the file
        assert hc.main(["--target", "4", "--out", out]) == 0
        merged = json.load(open(out))
    return records, base, fp32, merged


def test_records_follow_the_reference(runs, port_records):
    ref, _, _ = runs
    records, _, _, _ = port_records
    assert list(records) == list(ref["records"])
    for target, recs in ref["records"].items():
        got = records[target]
        assert [r["tag"] for r in got] == [r["tag"] for r in recs]
        for g, w in zip(got, recs):
            assert REF_KEYS <= g.keys() and g["compile_s"] is None
            assert g["model_flops"] == pytest.approx(w["model_flops"], rel=1e-12), g["tag"]
            for extra in ("plan", "exchange_model"):
                if extra in w:
                    assert g[extra].keys() == w[extra].keys()
                    for key, v in w[extra].items():
                        assert g[extra][key] == pytest.approx(v, rel=1e-12), (g["tag"], key)


def test_baselines_equal_run_cell(port_records):
    records, base, _, _ = port_records
    for target, arch in (("target1_moe", "moonshot-v1-16b-a3b"), ("target2_granite", "granite-34b"),
                         ("target3_pna", "pna"), ("target4_gemma_cache", "gemma3-12b")):
        rec, cell = records[target][0], base[arch]
        assert cell["status"] == "OK"
        roof = cell["roofline"]
        assert (rec["compute_s"], rec["memory_s"], rec["collective_s"]) == (
            roof["compute_s"], roof["memory_s"], roof["collective_s"])
        assert rec["collective_by_type"] == {k: v for k, v in cell["collective_bytes_per_device"].items() if v}
        assert rec["peak_bytes"] == cell["memory"]["peak_bytes"] and rec["model_flops"] == cell["model_flops"]


def test_record_checks(port_records):
    records, _, fp32, merged = port_records
    t2 = {r["tag"].split()[0]: r for r in records["target2_granite"]}
    t3 = {r["tag"].split()[0]: r for r in records["target3_pna"]}
    assert t3["t3-a"]["collective_by_type"]["total"] > t3["t3-baseline"]["collective_by_type"]["total"]
    assert t2["t2-a"]["peak_bytes"] < t2["t2-baseline"]["peak_bytes"]
    assert t2["t2-b"]["peak_bytes"] < t2["t2-a"]["peak_bytes"]
    assert {k: v for k, v in t2["t2-c"].items() if k not in ("tag", "note")} == {
        k: v for k, v in t2["t2-a"].items() if k != "tag"}
    assert 2 * t3["t3-c"]["collective_by_type"]["all-gather"] == fp32["collective_by_type"]["all-gather"]
    cfg = hr.small_spec("pna").make_config(hr.small_spec("pna").shapes["ogb_products"])
    assert t3["t3-c"]["counted_wire"]["all_gather_bytes_per_layer"] * cfg.n_layers == \
        t3["t3-c"]["collective_by_type"]["all-gather"]
    assert set(merged) == {"target1_moe", "target2_granite", "target3_pna", "target4_gemma_cache"}
    assert merged["target1_moe"] == records["target1_moe"]
