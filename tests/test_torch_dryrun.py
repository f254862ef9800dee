"""The port's dry run (`repro_torch.launch.dryrun`) and the GNN cells of
`repro_torch.launch.steps.build_cell` against the reference's.

* The reference's five dry-run tests of a pna cell, run against the port's
  cells and collective counter: the smoke on 4 × 16
  (tests/test_system.py), halo's wire below broadcast on 1 × 8 and the k = 1
  cell (tests/test_comm_default.py), a pod axis of width 1 (flat) and the
  pod-tiered 2 × 1 × 4 cell with its accounting (tests/test_hier_halo.py).
  Each runs `run_cell`, whose fake process group is destroyed on return,
  so no later test of the worker finds a default group.
* Every GNN cell's kind, comm, note, model_flops, plan arrays, batch and
  parameter shapes and `exchange_accounting` record equal the reference's
  `build_cell` on the same mesh (one JAX subprocess with 8 host devices),
  for coin_gcn (``cora``: full_graph_sm's graph), pna, egnn, graphcast and
  equiformer-v2 × full_graph_sm, molecule and minibatch_lg, with and
  without ``optimized`` and a wire payload; ogb_products through
  `_gnn_flops`, and equiformer-v2's big-edge ``edge_chunk``.
* One 4-rank gloo group on the CPU: the pna halo, hierarchical and
  broadcast cells' real train step counts exactly what their meta run
  counts (collectives by kind, bytes in and out, FLOPs), and each loss
  and gradient equals the same cell at k = 1.
* The k = 1 cell's loss, gradient and updated parameters equal the JAX
  cell's on ``make_local_mesh()`` fed the same numpy inputs (PNA in
  float64, as tests/test_torch_gnn_models.py holds its gradient).
* The CLI: schema-2 records with the reference's keys, the cached-cell
  skip, the mesh tags, ``--autotune-config``, equiformer-v2 recorded OK,
  an unknown shape as a FAIL with its error, and exit code 1.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core.autotune as ra
import repro_torch.core.autotune as ta
from repro_torch.configs.registry import get_arch, gnn_shapes
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import GroupSpec, Grid, halo_axes, run_group

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FLAT, PODS = (("data", "model"), (1, 8)), (("pod", "data", "model"), (2, 1, 4))
CASES = [(arch, shape) for arch in ("pna", "egnn", "graphcast", "equiformer-v2")
         for shape in ("full_graph_sm", "molecule", "minibatch_lg")]
CASES += [("coin_gcn", "cora")]
VARIANTS = [dict(), dict(optimized=True), dict(payload="bf16"), dict(payload="int8"), dict(comm="broadcast"),
            dict(optimized=True, payload="int8")]
PLAN_FIELDS = ("k", "n_local", "s_max", "e_local", "n_nodes", "perm", "send_idx", "senders_l", "receivers_l",
               "edge_w", "part_sizes", "n_pods", "s_loc", "s_rem", "send_loc", "send_rem")
CONSTANTS = ("PEAK_FLOPS", "ICI_BYTES_PER_S", "ENERGY_WEIGHT_S_PER_J", "BACKEND_EFFICIENCY", "BLOCK_GRID")


def _grid(axes, sizes):
    return Grid(tuple(axes), tuple(sizes))


# ------------------------------------------------- the reference's five tests
def test_dryrun_cell_smoke_4x16():
    rec = tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=_grid(("data", "model"), (4, 16)))
    assert rec["status"] == "OK" and rec["flops_per_device"] > 0 and rec["mesh"] == "4x16"


def _pna_cell(grid, **kw):
    spec = get_arch("pna")
    return tsteps.build_cell(spec, spec.shapes["full_graph_sm"], grid, **kw), spec.shapes["full_graph_sm"]


def test_default_cell_wire_below_broadcast_1x8():
    grid = _grid(*FLAT)
    cell, shape = _pna_cell(grid)
    assert cell.comm == "halo"
    ex = tdr.exchange_accounting(cell, shape)
    assert ex["halo_rows_per_device"] < ex["broadcast_rows_per_device"] and ex["wire_fraction"] < 1.0
    assert _pna_cell(grid, comm="broadcast")[0].comm == "broadcast"
    halo = tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=grid)
    bcast = tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=grid, comm="broadcast")
    assert bcast["mesh"] == "1x8+broadcast"
    h, b = halo["collective_bytes_per_device"], bcast["collective_bytes_per_device"]
    assert h["all-gather"] < b["all-gather"] and h["total"] < b["total"], (h, b)


def test_default_cell_one_device():
    grid = _grid(("data", "model"), (1, 1))
    cell, _ = _pna_cell(grid)
    assert cell.comm == "halo" and cell.halo_plan.k == 1 and cell.halo_plan.s_max == 0
    rec = tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=grid)
    assert rec["status"] == "OK" and rec["flops_per_device"] > 0
    assert rec["collectives_per_device"]["all-gather"]["count"] == 0


def test_size_one_pod_axis_degenerates_to_flat():
    grid = _grid(("pod", "data", "model"), (1, 1, 8))
    assert halo_axes(grid) == ("model",)
    cell, _ = _pna_cell(grid)
    assert cell.comm == "halo" and not cell.halo_plan.is_hierarchical
    assert "send_idx" in cell.abstract_inputs()[2]
    assert tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=grid)["flops_per_device"] > 0


def test_hier_cell_accounting():
    rec = tdr.run_cell("pna", "full_graph_sm", False, verbose=False, grid=_grid(*PODS))
    cell, shape = _pna_cell(_grid(*PODS))
    assert cell.comm == "halo" and cell.halo_plan.is_hierarchical
    assert cell.halo_plan.n_pods == 2 and cell.halo_plan.k == 8
    ex = tdr.exchange_accounting(cell, shape)
    assert ex["pods"] == 2 and ex["axes"] == ["pod", "model"]
    assert ex["inter_pod_rows_crossing"] < ex["flat_inter_pod_rows_crossing"], ex
    assert ex["halo_rows_per_device"] < ex["broadcast_rows_per_device"], ex
    assert rec["flops_per_device"] > 0 and rec["status"] == "OK"


# ------------------------------------------ every GNN cell against the reference's
_REF_SCRIPT = r"""
import os, sys, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import jax
jax.devices()                       # the device count is set before repro.launch.dryrun's import asks for 512
import numpy as np
from repro.configs import get_arch
import repro.launch.steps as ref_steps
from repro.launch.steps import build_cell, _gnn_flops
from repro.launch.dryrun import exchange_accounting
cases, variants, meshes, fields = pickle.loads(bytes.fromhex(sys.argv[2]))
out = {}
chunks = []                         # the edge_chunk each equiformer-v2 cell's loss closes over
_loss_fn = ref_steps._gnn_loss_fn
def _recording_loss_fn(arch_id, cfg, *a, **kw):
    if arch_id == "equiformer-v2":
        chunks.append(cfg.edge_chunk)
    return _loss_fn(arch_id, cfg, *a, **kw)
ref_steps._gnn_loss_fn = _recording_loss_fn
for mname, (axes, sizes) in meshes.items():
    mesh = jax.make_mesh(sizes, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    for arch, sname in cases:
        spec = get_arch(arch)
        shape = spec.shapes[sname]
        for vi, kw in enumerate(variants):
            chunks.clear()
            cell = build_cell(spec, shape, mesh, **kw)
            plan = cell.halo_plan
            batch = cell.abstract_args[2]
            rec = dict(kind=cell.kind, comm=cell.comm, note=cell.note, model_flops=cell.model_flops,
                       bsr_stats=cell.bsr_stats, halo_payload=cell.halo_payload, halo_overlap=cell.halo_overlap,
                       exchange=exchange_accounting(cell, shape),
                       batch={k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()},
                       params={"/".join(str(getattr(p, "key", p)) for p in path): tuple(l.shape)
                               for path, l in jax.tree_util.tree_flatten_with_path(cell.abstract_args[0])[0]},
                       edge_chunk=chunks[-1] if chunks else None)
            if plan is not None:
                rec["plan"] = {f: (np.asarray(getattr(plan, f)) if getattr(plan, f) is not None else None)
                               for f in fields}
            out[(mname, arch, sname, vi)] = rec
spec = get_arch("pna")
out["ogb"] = {a: _gnn_flops(a, get_arch(a).shapes["ogb_products"], get_arch(a).make_config(
    get_arch(a).shapes["ogb_products"])) for a in ("pna", "egnn", "graphcast", "equiformer-v2")}
sys.stdout.buffer.write(pickle.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_cells():
    arg = pickle.dumps((CASES, VARIANTS, {"flat": FLAT, "pods": PODS}, PLAN_FIELDS)).hex()
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, os.path.abspath(SRC), arg], capture_output=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    return pickle.loads(res.stdout)


def _same(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), (path, sorted(a), sorted(b))
        for k in b:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif isinstance(b, float) and isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _dtype_name(dtype) -> str:
    return {torch.float32: "float32", torch.int32: "int32", torch.int64: "int32"}[dtype]


@pytest.mark.parametrize("mesh", ["flat", "pods"])
@pytest.mark.parametrize("arch,shape", CASES)
def test_gnn_cells_equal_the_reference(reference_cells, monkeypatch, mesh, arch, shape):
    for name in CONSTANTS:
        monkeypatch.setattr(ta, name, getattr(ra, name))
    grid = _grid(*(FLAT if mesh == "flat" else PODS))
    spec = get_arch(arch)
    for vi, kw in enumerate(VARIANTS):
        ref = reference_cells[(mesh, arch, shape, vi)]
        cell = tsteps.build_cell(spec, spec.shapes[shape], grid, **kw)
        got = dict(kind=cell.kind, comm=cell.comm, note=cell.note, model_flops=cell.model_flops,
                   bsr_stats=cell.bsr_stats, halo_payload=cell.halo_payload, halo_overlap=cell.halo_overlap,
                   exchange=tdr.exchange_accounting(cell, spec.shapes[shape]))
        _same(got, {k: ref[k] for k in got}, f"{mesh}/{arch}/{shape}/{kw}")
        assert getattr(cell.cfg, "edge_chunk", None) == ref["edge_chunk"]
        params, _, batch = cell.abstract_inputs()
        flat_params = {k.strip("/"): tuple(v.shape) for k, v in tdr_leaves(params).items()}
        assert flat_params == ref["params"]
        got_batch = {k: (tuple(v.shape), _dtype_name(v.dtype)) for k, v in batch.items()}
        if cell.comm == "broadcast":
            # The reference shards the whole padded graph's arrays over `model`; a rank of the port
            # holds its n_pad / m nodes and the edges whose receivers it owns (padded with weight-0
            # edges: edge_w and node_mask are the port's), so only the node arrays compare.
            m = grid.shape["model"]
            nodes = {k: ((s[0] // m,) + s[1:], d) for k, (s, d) in ref["batch"].items()
                     if k not in ("senders", "receivers", "edge_feats", "edge_weight")}
            assert {k: got_batch[k] for k in nodes} == nodes
            continue
        # The reference's batch carries the leading device axis (k for a graph, the data shards for
        # blocks); a rank of the port holds one slice of it. Labels are int64 in the port.
        want = {k: (s[1:], d) for k, (s, d) in ref["batch"].items()}
        assert got_batch == want
        if ref.get("plan") is not None:
            _same({f: getattr(cell.halo_plan, f) for f in PLAN_FIELDS}, ref["plan"], f"{arch}/{shape}/plan")


def tdr_leaves(tree, prefix=""):
    """Leaves by path; a list's entries as ``[i]``, as JAX names a sequence key."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tdr_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in tdr_leaves(x, f"{prefix}/[{i}]").items()}
    return {prefix: tree}


def test_ogb_products_flops_and_equiformer(reference_cells):
    for arch, want in reference_cells["ogb"].items():
        spec = get_arch(arch)
        shape = spec.shapes["ogb_products"]
        assert tsteps._gnn_flops(arch, shape, spec.make_config(shape)) == want
    assert set(reference_cells["ogb"]) == {"pna", "egnn", "graphcast", "equiformer-v2"}
    # equiformer-v2's big-edge rule: more than 2,000,000 edges (the shape's) run 64 chunks of ceil(E / 64).
    spec = get_arch("equiformer-v2")
    for mesh in ("flat", "pods"):
        want = reference_cells[(mesh, "equiformer-v2", "minibatch_lg", 0)]["edge_chunk"]
        cell = tsteps._gnn_cell(spec, gnn_shapes()["minibatch_lg"], _grid(*(FLAT if mesh == "flat" else PODS)),
                                torch.float32)
        assert cell.cfg.edge_chunk == want == -(-114_615_892 // 64)
        small = tsteps._gnn_cell(spec, gnn_shapes()["full_graph_sm"], _grid(*FLAT), torch.float32)
        assert small.cfg.edge_chunk is None


# --------------------------------------------- a real 4-rank step against meta
JOBS = [tdr.StepJob("pna", "full_graph_sm", sizes=(1, 4)),
        tdr.StepJob("pna", "full_graph_sm", axes=("pod", "data", "model"), sizes=(2, 1, 2)),
        tdr.StepJob("pna", "full_graph_sm", sizes=(1, 4), comm="broadcast"),
        tdr.StepJob("pna", "full_graph_sm", sizes=(1, 4), payload="int8", keep=False),
        tdr.StepJob("coin_gcn", "cora", sizes=(1, 4), optimized=True, quant_off=True)]


@pytest.fixture(scope="module")
def group_steps():
    real = run_group(GroupSpec(k=4, timeout_s=600.0), tdr.real_steps, [JOBS] * 4)
    meta = {r: tdr.meta_steps(JOBS, rank=r) for r in (0, 3)}
    return real, meta


@pytest.mark.parametrize("job", JOBS, ids=lambda j: j.tag())
def test_real_step_counts_what_meta_counts(group_steps, job):
    real, meta = group_steps
    for r in (0, 3):
        got, want = real[r][job.tag()], meta[r][job.tag()]
        assert got["flops"] == want["flops"] > 0
        assert got["collectives"] == want["collectives"]
    if job.keep:
        one = dataclasses.replace(job, axes=("data", "model"), sizes=(1, 1))
        ref = tdr.real_steps(0, 1, "cpu", [one])[one.tag()]
        assert abs(real[0][job.tag()]["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        if job.arch != "pna":        # PNA's fp32 gradient is ill-conditioned (tests/test_torch_gnn_models.py)
            for k, v in tdr_leaves(ref["grads"]).items():
                g = tdr_leaves(real[0][job.tag()]["grads"])[k]
                assert np.abs(g - v).max() <= 1e-4 * max(np.abs(v).max(), 1e-30), k


def test_halo_counts_below_broadcast(group_steps):
    real, _ = group_steps
    halo, bcast = real[0][JOBS[0].tag()]["collectives"], real[0][JOBS[2].tag()]["collectives"]
    assert halo["all-gather"]["bytes_out"] < bcast["all-gather"]["bytes_out"]
    assert halo["total"]["bytes_out"] < bcast["total"]["bytes_out"]
    assert halo["reduce-scatter"]["count"] == bcast["reduce-scatter"]["count"] == 4      # the gathers' transposes


# ------------------------------------------------ the k = 1 cell against JAX's
_JAX_STEP = r"""
import os, sys, pickle
sys.path.insert(0, sys.argv[1])
import jax, numpy as np
arch, shape_name, x64, inputs = pickle.load(open(sys.argv[2], "rb"))
jax.config.update("jax_enable_x64", x64)
import jax.numpy as jnp
from repro.configs import get_arch
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import build_cell
mesh = make_local_mesh()
spec = get_arch(arch)
cell = build_cell(spec, spec.shapes[shape_name], mesh)
params, opt_state, batch = jax.tree_util.tree_map(jnp.asarray, inputs)
with mesh:
    p, o, loss = jax.jit(cell.fn)(params, opt_state, batch)
sys.stdout.buffer.write(pickle.dumps(jax.tree_util.tree_map(np.asarray, (p, o, loss))))
"""


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


@pytest.mark.parametrize("arch,shape,dtype", [("pna", "full_graph_sm", "float64"), ("egnn", "full_graph_sm", "float32"),
                                              ("coin_gcn", "cora", "float32")])
def test_k1_cell_step_equals_jax(tmp_path, arch, shape, dtype):
    job = tdr.StepJob(arch, shape, dtype=dtype, seed=3)
    cell = job.cell().bind()
    params, opt_state, batch = cell.make_inputs(job.seed, "cpu")
    inputs = (_np(params), {"m": _np(opt_state["m"]), "v": _np(opt_state["v"]), "step": np.int32(0)},
              {k: (_np(v).astype(np.int32) if v.dtype == torch.int64 else _np(v))[None] for k, v in batch.items()})
    arg = tmp_path / "inputs.pkl"
    arg.write_bytes(pickle.dumps((arch, shape, dtype == "float64", inputs)))
    res = subprocess.run([sys.executable, "-c", _JAX_STEP, os.path.abspath(SRC), str(arg)], capture_output=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr.decode()[-3000:]
    j_params, j_opt, j_loss = pickle.loads(res.stdout)
    run = tdr.count_step(cell.fn, (params, opt_state, batch))
    t_params, t_opt, t_loss = run["out"]
    assert abs(float(t_loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    tg, jg = tdr_leaves(_np(t_opt["m"])), tdr_leaves(j_opt["m"])
    tp, jp = tdr_leaves(_np(t_params)), tdr_leaves(j_params)
    assert tg.keys() == jg.keys() == tp.keys()
    for k in jg:
        scale = max(float(np.abs(jg[k]).max()), 1e-30)
        assert np.abs(tg[k] - jg[k]).max() <= 1e-4 * scale, k                 # the gradient, · (1 − b1)
        # AdamW's first step moves each parameter by lr·sign(g): in fp32 held where the gradient is not
        # rounding noise; in float64 every parameter is held.
        sel = np.abs(jg[k]) >= (0.0 if dtype == "float64" else 1e-4) * scale
        assert np.abs(tp[k] - jp[k])[sel].max(initial=0.0) <= 1e-4 * max(float(np.abs(jp[k]).max()), 1e-30), k


# -------------------------------------------------------------------- the CLI
def test_cli_records_cache_tags_and_failures(tmp_path, capsys):
    out = str(tmp_path / "dry.json")
    assert tdr.main(["--arch", "pna", "--shape", "molecule", "--out", out]) == 0
    recs = tdr.load_results(out)
    assert json.load(open(out))["schema"] == 2 and len(recs) == 1
    rec = recs[0]
    keys = {"arch", "shape", "mesh", "ts", "status", "kind", "n_chips", "lower_s", "compile_s", "flops_per_device",
            "hbm_bytes_per_device", "collective_bytes_per_device", "memory", "roofline", "model_flops",
            "useful_flops_ratio", "note", "exchange"}
    assert keys <= rec.keys() and rec["mesh"] == "16x16" and rec["status"] == "OK" and rec["compile_s"] is None
    assert {"compute_s", "memory_s", "collective_s", "dominant"} <= rec["roofline"].keys()
    assert set(rec["collective_bytes_per_device"]) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                                       "collective-permute", "total"}
    capsys.readouterr()
    assert tdr.main(["--arch", "pna", "--shape", "molecule", "--out", out]) == 0
    assert "[cached] ('pna', 'molecule', '16x16')" in capsys.readouterr().out
    cfg = tmp_path / "tuned.json"
    cfg.write_text(json.dumps({"config": {"payload": "int8", "backend": "bsr", "pods": 2}}))
    assert tdr.main(["--arch", "coin_gcn", "--shape", "cora", "--autotune-config", str(cfg), "--out", out]) == 0
    assert tdr.main(["--arch", "pna", "--shape", "molecule", "--comm", "broadcast", "--out", out]) == 0
    tags = {(r["arch"], r["mesh"]) for r in tdr.load_results(out)}
    assert {("coin_gcn", "2x16x16+opt+int8"), ("pna", "16x16+broadcast")} <= tags
    assert tdr.main(["--arch", "equiformer-v2", "--shape", "molecule", "--out", out]) == 0
    eq = [r for r in tdr.load_results(out) if r["arch"] == "equiformer-v2"]
    assert eq[0]["status"] == "OK" and eq[0]["flops_per_device"] > 0
    assert tdr.main(["--arch", "pna", "--shape", "no_such_shape", "--out", out]) == 1
    fail = [r for r in tdr.load_results(out) if r["shape"] == "no_such_shape"]
    assert fail[0]["status"] == "FAIL" and "no_such_shape" in fail[0]["error"]
    assert tdr.RESULTS_PATH == "results/dryrun_torch.json"
