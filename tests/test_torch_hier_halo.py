"""The port's hierarchical (pod, model) halo exchange against the JAX
package's, on the CPU.

One 4-rank `gloo` group (`repro_torch.launch.mesh.run_group`, spawned once
for the module; rank body `_torch_halo_ranks.hier_checks`) laid out as 2
pods × 2 ranks (`repro_torch.launch.mesh.halo_groups`), and one subprocess
running the reference on 4 emulated host devices on a ``(2, 2)`` ``("pod",
"model")`` mesh with Auto axes (under jax 0.9 ``jax.make_mesh`` builds
Explicit axes, over which the reference's gradients and its jitted
`Trainer` fail: ROADMAP queue 3), started side by side. Both compute, from
the same numpy graph (``citation_like(400, 2400)``), features, labels, mask
and parameters (widths 16 → 32 → 7: layer 1 aggregation-first, layer 2
feature-first):

* `hier_halo_exchange` per wire format and lowering, its rows per phase,
  and the pull-back of a seeded cotangent through it (``jax.vjp``);
* the flat `halo_exchange` of a bf16 table over the int8 wire;
* the sharded forward of every variant below (quant off and on, segment
  and bsr, every wire format), held against the reference's hierarchical
  forward, against the port's flat forward on the same partition, and
  (quant off, fp32 wire) against the unsharded forward — ≤ 1e-4, as
  tests/test_hier_halo.py:335;
* the gradient of the sharded loss (``psum`` over both axes: the whole
  group) in the gradient variants (``jax.jit(jax.value_and_grad)``);
* three AdamW steps of a `Trainer` on reduced Cora at 2 × 2.

Tolerances, the reference suite's (ROADMAP.md's parity contract): the
exchange exact (rows are copies, int8 codes the same arithmetic; 1e-6 for
int8's decode); the forward 3e-4 (bsr against segment order), 5e-2 under a
bf16 wire, the int8 bound of tests/test_overlap_halo.py:243-250; gradients
2e-5 of each one's largest entry (5e-2 under bf16; int8 passes the scales'
cotangents only, as the reference does).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_halo_ranks
from repro_torch.core.partition import partition_graph
from repro_torch.dist.halo import build_halo_plan, plan_blocked_rank, relocate_node_array, restore_node_array
from repro_torch.graph.generators import citation_like, make_dataset
from repro_torch.launch.distributed_gcn import HaloVariant, rank_jobs
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_forward

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K, PODS = 4, 2
AX = ("pod", "model")
DIMS = (16, 32, 7)
FP32_TOL, BF16_TOL, INT8_ABS, INT8_REL = 3e-4, 5e-2, 5e-2, 1e-2
HIER_FLAT_TOL = 1e-4         # tests/test_hier_halo.py:335
GRAD_RTOL = 2e-5
TRAJ_STEPS, TRAJ_LR = 3, 1e-2

V = HaloVariant
FORWARD = (
    V("seg_fp32", backend="segment"),
    V("seg_fp32_serial_ppermute", backend="segment", overlap=False, via="ppermute"),
    V("bsr_fp32"),
    V("bsr_split_fp32", split=True),
    V("seg_quant", backend="segment", quant=True),
    V("bsr_quant", quant=True),
    V("seg_bf16", backend="segment", payload="bf16"),
    V("bsr_bf16", payload="bf16"),
    V("bsr_int8_ppermute", payload="int8", via="ppermute"),
)
ON_FLAT = tuple(v for v in FORWARD if v.payload is None)
UNSHARDED = [v.name for v in ON_FLAT if not v.quant]
GRADS = (
    V("g_seg_fp32", backend="segment"),
    V("g_bsr_fp32"),
    V("g_bsr_split_fp32", split=True),
    V("g_seg_bf16", backend="segment", payload="bf16"),
    V("g_bsr_int8_ppermute", payload="int8", via="ppermute"),
    V("g_bsr_quant", quant=True),
)


def _inputs():
    """Seeded numpy inputs: receiver-normalized positive weights, 16-wide
    features, parameters with nonzero biases, labels, and the training mask
    (the nodes whose id is not a multiple of 4)."""
    g = citation_like(400, 2400, seed=5)
    r = np.random.default_rng(0)
    w = np.abs(r.standard_normal(g.n_edges)).astype(np.float32) + 0.1
    deg = np.bincount(g.edge_index[1], weights=w, minlength=g.n_nodes)
    w = (w / deg[g.edge_index[1]]).astype(np.float32)
    x = np.random.default_rng(1).standard_normal((g.n_nodes, DIMS[0])).astype(np.float32)
    r = np.random.default_rng(2)
    params = {}
    for i, (a, b) in enumerate(zip(DIMS[:-1], DIMS[1:])):
        params[f"w{i}"] = (r.standard_normal((a, b)) * (2.0 / (a + b)) ** 0.5).astype(np.float32)
        params[f"b{i}"] = (0.1 * r.standard_normal(b)).astype(np.float32)
    labels = np.random.default_rng(3).integers(0, DIMS[-1], g.n_nodes).astype(np.int32)
    mask = (np.arange(g.n_nodes) % 4 != 0).astype(np.float32)
    return g, w, x, params, labels, mask


def _cora():
    spec, g = make_dataset("cora", reduced=True)
    gs = g.symmetrized().with_self_loops()
    cw = gs.sym_normalized_weights()
    part = partition_graph(gs.n_nodes, gs.edge_index, K, method="bfs", seed=0, refine=True)
    dims = (spec.n_features, spec.hidden, spec.n_labels)
    r = np.random.default_rng(7)
    params = {f"{n}{i}": (r.standard_normal((a, b)) * (2.0 / (a + b)) ** 0.5 if n == "w"
                          else 0.1 * r.standard_normal(b)).astype(np.float32)
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])) for n in ("w", "b")}
    return g, gs, cw, part, dims, params


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={k}"
import sys; sys.path.insert(0, {src!r})
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.core.partition import partition_graph
from repro.core.quant import QuantConfig
from repro.dist.halo import (build_halo_plan, halo_exchange, hier_halo_exchange, node_mask,
                             plan_blocked_adjacency, plan_split_blocked_adjacency, relocate_node_array,
                             restore_node_array)
from repro.dist.policy import ShardingPolicy
from repro.graph.generators import make_dataset
from repro.models.gcn import GCNConfig, gcn_forward
from repro.train.loop import Trainer, TrainerConfig
from repro.train.optimizer import adamw

d = np.load({inputs!r})
AX = ("pod", "model")
mesh = jax.make_mesh(({pods}, {k} // {pods}), AX, axis_types=(AxisType.Auto, AxisType.Auto))
mesh1 = jax.make_mesh(({k},), ("model",), axis_types=(AxisType.Auto,))


def smap(body, n, m=mesh, ax=AX):
    return jax.shard_map(body, mesh=m, in_specs=(P(ax),) * n, out_specs=P(ax), check_vma=False)


def plan_batch(plan, x, labels, mask):
    sloc, srem, sl, rl, ew = plan.device_arrays()
    return {{"feats": jnp.asarray(relocate_node_array(plan, x)),
            "labels": jnp.asarray(relocate_node_array(plan, labels)), "mask": jnp.asarray(mask),
            "send_loc": sloc, "send_rem": srem, "senders": sl, "receivers": rl, "edge_w": ew}}


def run_gcn(params, b, cfg, v, tabs):
    kw = {{}}
    if v["backend"] == "bsr":
        kw["adjacency"] = (tabs[0], tabs[1], tabs[2])
        if v["split"]:
            kw["adjacency_boundary"] = (tabs[3], tabs[4], tabs[5])
    pol = ShardingPolicy(comm="halo", halo_axes=AX, halo_payload=v["payload"], halo_overlap=v["overlap"],
                         halo_via=v["via"]).bind_halo(send_loc=b["send_loc"], send_rem=b["send_rem"])
    return gcn_forward(params, b["feats"], b["senders"], b["receivers"], b["edge_w"], cfg, pol, **kw)


def tables_of(plan, v):
    if v["backend"] != "bsr":
        return {{}}
    if v["split"]:
        ia, bd = plan_split_blocked_adjacency(plan)
        t = ia.device_arrays() + bd.device_arrays()
    else:
        t = plan_blocked_adjacency(plan).device_arrays()
    return {{f"t{{i}}": a for i, a in enumerate(t)}}


def cfg_of(v, dims):
    return GCNConfig(layer_dims=tuple(dims), dataflow=v["dataflow"], backend=v["backend"],
                     quant=QuantConfig(enabled=v["quant"]))


def forward_of(cfg, v, params):
    def fwd(batch):
        keys = sorted(batch)

        def body(*args):
            b = {{kk: a[0] for kk, a in zip(keys, args)}}
            tabs = [b[f"t{{i}}"] for i in range(6) if f"t{{i}}" in b]
            return run_gcn(params, b, cfg, v, tabs).astype(jnp.float32)[None]

        return smap(body, len(keys))(*[batch[kk] for kk in keys])
    return fwd


def loss_of(cfg, v):
    def loss_fn(params, batch):
        keys = sorted(batch)

        def body(*args):
            b = {{kk: a[0] for kk, a in zip(keys, args)}}
            tabs = [b[f"t{{i}}"] for i in range(6) if f"t{{i}}" in b]
            logits = run_gcn(params, b, cfg, v, tabs).astype(jnp.float32)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, b["labels"][:, None], axis=-1)[:, 0]
            wsum = ((lse - gold) * b["mask"]).sum()
            loss = jax.lax.psum(wsum, AX) / jnp.maximum(jax.lax.psum(b["mask"].sum(), AX), 1.0)
            return loss[None]

        return smap(body, len(keys))(*[batch[kk] for kk in keys]).mean()
    return loss_fn


out = {{}}
ei, w, x = d["edge_index"], d["w"], d["x"]
part = partition_graph(x.shape[0], ei, {k}, method="bfs", seed=0, refine=True)
hier = build_halo_plan(part, ei, w, axes=AX, pods={pods})
flat = build_halo_plan(part, ei, w)
batch = plan_batch(hier, x, d["labels"], relocate_node_array(hier, d["mask"]) * node_mask(hier))
params = {{n: jnp.asarray(d["p_" + n]) for n in ("w0", "b0", "w1", "b1")}}

# The two-phase exchange, and its pull-back (jitted jax.vjp inside shard_map).
zb, ct, sloc, srem = jnp.asarray(d["z"]), jnp.asarray(d["ct"]), batch["send_loc"], batch["send_rem"]
for via in ("all_gather", "ppermute"):
    for payload in ("fp32", "bf16", "int8"):
        f = smap(lambda z, a, b, via=via, payload=payload:
                 hier_halo_exchange(z[0], a[0], b[0], AX, via=via, payload=payload)[None], 3)

        def both(z, c, f=f):
            halo, pull = jax.vjp(lambda zz: f(zz, sloc, srem), z)
            return halo, pull(c)[0]

        halo, dz = jax.jit(both)(zb, ct)
        out[f"halo_{{via}}_{{payload}}"], out[f"dz_{{via}}_{{payload}}"] = np.asarray(halo), np.asarray(dz)

# The flat exchange of a bf16 table over the int8 wire.
f = smap(lambda z, s: halo_exchange(z[0], s[0], "model", payload="int8")[None], 2, mesh1, "model")
h16 = f(jnp.asarray(d["z16"]).astype(jnp.bfloat16), flat.device_arrays()[0])
out["flat_int8_bf16"] = np.asarray(h16.astype(jnp.float32))
out["flat_int8_bf16_dtype"] = np.asarray(str(h16.dtype))

# The hierarchical forward of every variant, in global node order.
for v in json.loads(str(d["forward"])):
    b = dict(batch, **tables_of(hier, v))
    b.pop("labels"), b.pop("mask")
    fwd = jax.jit(forward_of(cfg_of(v, d["dims"]), v, params))
    out["fwd_" + v["name"]] = restore_node_array(hier, np.asarray(fwd(b)))

# The sharded loss's value and gradient.
for v in json.loads(str(d["grads"])):
    loss, grads = jax.jit(jax.value_and_grad(loss_of(cfg_of(v, d["dims"]), v)))(
        params, dict(batch, **tables_of(hier, v)))
    out["loss_" + v["name"]] = np.asarray(loss)
    for n, g in grads.items():
        out[f"grad_{{v['name']}}_{{n}}"] = np.asarray(g)

# Three AdamW steps of the reference Trainer, reduced Cora at 2 × 2.
spec, g = make_dataset("cora", reduced=True)
gs = g.symmetrized().with_self_loops()
cw = gs.sym_normalized_weights()
cpart = partition_graph(gs.n_nodes, gs.edge_index, {k}, method="bfs", seed=0, refine=True)
cplan = build_halo_plan(cpart, gs.edge_index, cw, axes=AX, pods={pods})
cbatch = plan_batch(cplan, g.features.astype(np.float32), g.labels.astype(np.int32), node_mask(cplan))
seg = dict(backend="segment", payload=None, overlap=True, via="all_gather", split=False, dataflow="auto",
           quant=False)
tr = Trainer(loss_of(cfg_of(seg, (spec.n_features, spec.hidden, spec.n_labels)), seg), adamw({lr}),
             {{n: jnp.asarray(d["c_" + n]) for n in ("w0", "b0", "w1", "b1")}}, TrainerConfig(log_every=100))
out["traj_losses"] = np.asarray(tr.fit(iter(lambda: cbatch, None), max_steps={steps}))
for n, p in tr.params.items():
    out["traj_" + n] = np.asarray(p)
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def case():
    g, w, x, params, labels, mask = _inputs()
    part = partition_graph(g.n_nodes, g.edge_index, K, method="bfs", seed=0, refine=True)
    hier = build_halo_plan(part, g.edge_index, w, axes=AX, pods=PODS)
    flat = build_halo_plan(part, g.edge_index, w)
    r = np.random.default_rng(4)
    z = relocate_node_array(hier, r.standard_normal((g.n_nodes, 12)).astype(np.float32))
    ct = r.standard_normal((K, hier.k_model * hier.block_rows, 12)).astype(np.float32)
    z16 = torch.from_numpy(3.0 * r.standard_normal((K, flat.n_local, 12))).to(torch.bfloat16).float().numpy()
    return dict(g=g, w=w, x=x, params=params, labels=labels, mask=mask, hier=hier, flat=flat, z=z, ct=ct,
                z16=z16, cora=_cora())


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """(the port's per-rank reports, the reference's outputs): the JAX
    subprocess runs while the port's group does."""
    work = tmp_path_factory.mktemp("hier_halo")
    inputs, outputs = work / "inputs.npz", work / "outputs.npz"
    cg, gs, cw, cpart, cdims, cparams = case["cora"]
    np.savez(inputs, edge_index=case["g"].edge_index, w=case["w"], x=case["x"], dims=np.array(DIMS),
             labels=case["labels"], mask=case["mask"], z=case["z"], ct=case["ct"], z16=case["z16"],
             forward=json.dumps([dataclasses.asdict(v) for v in FORWARD]),
             grads=json.dumps([dataclasses.asdict(v) for v in GRADS]),
             **{f"p_{n}": p for n, p in case["params"].items()}, **{f"c_{n}": p for n, p in cparams.items()})
    code = _REFERENCE.format(k=K, pods=PODS, src=SRC, inputs=str(inputs), outputs=str(outputs), lr=TRAJ_LR,
                             steps=TRAJ_STEPS)
    ref = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        hier, flat = case["hier"], case["flat"]
        fwd = rank_jobs(hier, case["x"], case["params"], DIMS, FORWARD, labels=case["labels"], mask=case["mask"],
                        train_variants=GRADS)
        on_flat = rank_jobs(flat, case["x"], case["params"], DIMS, ON_FLAT)
        cplan = build_halo_plan(cpart, gs.edge_index, cw, axes=AX, pods=PODS)
        traj = rank_jobs(cplan, cg.features.astype(np.float32), cparams, cdims, (), labels=cg.labels,
                         train_variants=(V("cora", backend="segment"),), steps=TRAJ_STEPS, lr=TRAJ_LR)
        jobs = [{"plan": hier, "flat_plan": flat, "z": case["z"][r], "ct": case["ct"][r], "z16": case["z16"][r],
                 "hier": fwd[r], "flat": on_flat[r], "trajectory": traj[r]} for r in range(K)]
        ranks = run_group(GroupSpec(k=K, backend="gloo", devices=("cpu",), timeout_s=600),
                          _torch_halo_ranks.hier_checks, jobs)
        stdout, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "OK" in stdout, (stdout[-2000:], stderr[-4000:])
    return ranks, dict(np.load(outputs))


def _rel_close(got, want, rtol, what):
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def _restored(plan, ranks, job, name):
    return restore_node_array(plan, np.stack([r[job]["variants"][name]["logits"] for r in ranks]))


# ------------------------------------------------------------------ groups
def test_rank_groups_are_pod_major(runs):
    """Rank g is member g % 2 of pod g // 2: its pod group (phase 1) holds
    the ranks of its member index, its model group (phase 2) the ranks of
    its pod; `MeshPlan((2, 2)).build()` gives the same groups by axis; one
    pod is the flat schedule (no subgroups)."""
    ranks, _ = runs
    for g, rec in enumerate(ranks):
        assert rec["pods_1_is_flat"]
        pod, model = rec["groups"]
        assert pod == [g % 2, g % 2 + 2] and model == [2 * (g // 2), 2 * (g // 2) + 1]
        assert rec["mesh"] == {"data": pod, "model": model}


def test_hier_blocked_tables_equal_reference(case):
    """Every rank's blocked table of the hierarchical plan (columns
    ``n_local + k_model·B``) is array-equal to the reference's slice."""
    from repro.dist.halo import build_halo_plan as j_build, plan_blocked_adjacency as j_blocked

    g, hier = case["g"], case["hier"]
    part = partition_graph(g.n_nodes, g.edge_index, K, method="bfs", seed=0, refine=True)
    theirs = j_blocked(j_build(part, g.edge_index, case["w"], axes=AX, pods=PODS))
    assert theirs.n_cols == hier.n_local + hier.k_model * hier.block_rows
    for r in range(K):
        ba = plan_blocked_rank(hier, r, max_nnzb=theirs.max_nnzb)
        np.testing.assert_array_equal(ba.block_vals, theirs.vals[r])
        np.testing.assert_array_equal(ba.block_cols, theirs.cols[r])
        np.testing.assert_array_equal(ba.row_nnzb, theirs.lens[r])


# ---------------------------------------------------------------- exchange
@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("payload", _torch_halo_ranks.PAYLOADS)
def test_hier_exchange_matches_jax(case, runs, via, payload):
    """The member-block halo on every rank equals the reference's; the
    rows received per phase are n_pods·s_rem (pod group) and k_model·B
    (model group)."""
    ranks, ref = runs
    hier = case["hier"]
    want = ref[f"halo_{via}_{payload or 'fp32'}"]
    for r, rec in enumerate(ranks):
        got = rec["halo"][via, payload]
        assert got.shape == (hier.k_model * hier.block_rows, 12)
        if payload == "int8":
            np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want[r])
        assert rec["phase_rows"][via, payload] == {"inter_pod": hier.n_pods * hier.s_rem,
                                                   "intra_pod": hier.k_model * hier.block_rows}


@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("payload", _torch_halo_ranks.PAYLOADS)
def test_hier_exchange_gradient_matches_jax_vjp(runs, via, payload):
    """Phase 2's transpose, the split, phase 1's transpose on the relayed
    rows, and both scatter-adds into h (rows exported on both tiers get
    both): every rank's pull-back equals ``jax.vjp``'s."""
    ranks, ref = runs
    want = ref[f"dz_{via}_{payload or 'fp32'}"]
    for r, rec in enumerate(ranks):
        _rel_close(rec["dz"][via, payload], want[r], BF16_TOL if payload == "bf16" else GRAD_RTOL, (via, payload, r))


@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
def test_rows_on_both_tiers_get_both_gradients(case, runs, via):
    """The pull-back of a cotangent of ones counts the halo slots, over all
    ranks, that hold each local row: k_model per ``send_loc`` entry (its
    pod-mates' phase 2) and n_pods·k_model per ``send_rem`` entry (phase 1
    across pods, each copy relayed to k_model pod-mates) — so a row on
    both tiers (the plan has some) gets both gradients."""
    ranks, _ = runs
    hier = case["hier"]
    both = 0
    for r, rec in enumerate(ranks):
        loc = np.bincount(hier.send_loc[r], minlength=hier.n_local)
        rem = np.bincount(hier.send_rem[r], minlength=hier.n_local)
        want = hier.k_model * loc + hier.n_pods * hier.k_model * rem
        np.testing.assert_array_equal(rec["dz_ones", via], np.broadcast_to(want[:, None], (hier.n_local, 12)))
        both += int(((loc > 0) & (rem > 0)).sum())
    assert both > 0


def test_overlap_timeline_returns_the_halo_aggregate(case, runs):
    """`overlap_timeline`'s interior and boundary terms, run around the
    asynchronous collective, add up to the serialized aggregate: on the 2 × 2
    groups (fp32) and on the flat group over the bf16 wire."""
    ranks, _ = runs
    assert case["hier"].n_local == case["flat"].n_local       # one partition: the same blocks
    for rec in ranks:
        for kind, (timeline, aggregate) in rec["overlap"].items():
            np.testing.assert_allclose(timeline, aggregate, rtol=1e-6, atol=1e-6, err_msg=kind)


def test_flat_int8_wire_on_a_bf16_table_matches_jax(runs):
    """`halo_exchange(payload="int8")` of a bf16 table: the codes divide in
    fp32 in both packages, so the decoded halo and its dtype equal the
    reference's."""
    ranks, ref = runs
    for r, rec in enumerate(ranks):
        got, dtype = rec["flat_int8_bf16"]
        assert dtype == str(ref["flat_int8_bf16_dtype"])
        np.testing.assert_array_equal(got, ref["flat_int8_bf16"][r])


# ----------------------------------------------------------------- forward
@pytest.mark.parametrize("name", [v.name for v in FORWARD])
def test_hier_forward_matches_jax(case, runs, name):
    ranks, ref = runs
    out = _restored(case["hier"], ranks, "hier", name)
    want = ref["fwd_" + name]
    assert out.shape == (case["g"].n_nodes, DIMS[-1]) and np.isfinite(out).all()
    if "int8" in name:
        err, rel = np.abs(out - want).max(), np.linalg.norm(out - want) / np.linalg.norm(want)
        assert err < INT8_ABS and rel < INT8_REL, (name, err, rel)
    else:
        tol = BF16_TOL if "bf16" in name else FP32_TOL
        np.testing.assert_allclose(out, want, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", [v.name for v in ON_FLAT])
def test_hier_equals_flat(case, runs, name):
    """The same variant over the flat plan of the same partition (quant on
    too: each rank calibrates on the same block either way)."""
    ranks, _ = runs
    hier = _restored(case["hier"], ranks, "hier", name)
    flat = _restored(case["flat"], ranks, "flat", name)
    assert np.abs(hier - flat).max() < HIER_FLAT_TOL, name


@pytest.mark.parametrize("name", UNSHARDED)
def test_hier_equals_unsharded(case, runs, name):
    """Quant off, fp32 wire: the unsharded forward of the whole graph."""
    ranks, _ = runs
    g = case["g"]
    ei = torch.from_numpy(g.edge_index)
    ref = gcn_forward({n: torch.from_numpy(p) for n, p in case["params"].items()}, torch.from_numpy(case["x"]),
                      ei[0], ei[1], torch.from_numpy(case["w"]), GCNConfig(layer_dims=DIMS)).numpy()
    assert np.abs(_restored(case["hier"], ranks, "hier", name) - ref).max() < HIER_FLAT_TOL, name


def test_hier_forward_counts_both_phases(case, runs):
    """Each forward receives both phases' rows per layer: n_layers ·
    (n_pods·s_rem + k_model·B), on every rank and variant."""
    ranks, _ = runs
    hier = case["hier"]
    for rec in ranks:
        for name, v in rec["hier"]["variants"].items():
            assert v["wire_rows"] == (len(DIMS) - 1) * hier.halo_rows_per_device, name


# --------------------------------------------------------------- gradients
@pytest.mark.parametrize("name", [v.name for v in GRADS])
def test_hier_sharded_gradient_matches_jax(runs, name):
    """Every rank's loss and gradient of the sharded loss (``psum`` over the
    whole group) against ``jax.jit(jax.value_and_grad)``."""
    ranks, ref = runs
    v = next(v for v in GRADS if v.name == name)
    rtol = {None: GRAD_RTOL, "bf16": BF16_TOL, "int8": BF16_TOL}[v.payload]
    for rec in ranks:
        run = rec["hier"]["train"][name]
        assert run["finite"]
        np.testing.assert_allclose(run["loss0"], float(ref[f"loss_{name}"]), rtol=max(rtol, 1e-6))
        for n, g in run["grads"].items():
            _rel_close(g, ref[f"grad_{name}_{n}"], rtol, (name, n))


def test_hier_trainer_trajectory_matches_jax(runs):
    """Three AdamW steps of every rank's Trainer against the reference's
    jitted Trainer on the example's loss, reduced Cora at 2 × 2."""
    ranks, ref = runs
    for rec in ranks:
        run = rec["trajectory"]["cora"]
        assert run["steps_run"] == TRAJ_STEPS
        np.testing.assert_allclose(run["losses"], ref["traj_losses"], rtol=2e-5)
        for n, p in run["params"].items():
            _rel_close(p, ref[f"traj_{n}"], 1e-4, n)
