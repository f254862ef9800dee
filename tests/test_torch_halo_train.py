"""The port's sharded (halo) training against the JAX package's, on the CPU.

One 4-rank `gloo` group (`repro_torch.launch.mesh.run_group`, spawned once
for the module; rank body `_torch_halo_ranks.train_grads_and_resume`) and
one subprocess running the reference on 4 emulated host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), started side by
side. Both compute, from the same numpy graph, features, labels, mask and
parameters:

* the pull-back of a seeded cotangent through `halo_exchange`, per wire
  format and lowering (the reference: ``jax.vjp`` inside ``shard_map``);
* the gradient of the sharded loss of ``examples/train_distributed_gcn.py``
  (``psum(wsum) / max(psum(wcnt), 1)``) in every variant below (the
  reference: ``jax.jit(jax.value_and_grad(loss_fn))``);
* `compressed_psum_mean`, the int8 data-parallel mean;
* three AdamW steps (lr 1e-2) of a `Trainer` on the example's loss over
  reduced Cora (the reference's jitted `Trainer`; the port's `Trainer` on
  every rank), which checkpoint every step: rank 0 writes, and a second
  run on every rank resumes from the last step.

The reference's mesh has Auto axes: under jax 0.9 ``jax.make_mesh``
builds Explicit ones, over which an unjitted ``jax.grad`` of the loss
raises and the jitted `Trainer` refuses the closed-over parameters (ROADMAP
queue 3; the reference is not edited).

Tolerances, the reference suite's (ROADMAP.md's parity contract): 2e-5
relative to each gradient's largest entry in fp32; 5e-2 under a bf16 wire
(the wire, the fused layer's output and its recompute round to bf16). Under
an int8 wire no gradient crosses the codes (rounding has no derivative):
only the scale's, which `amax` sends to one element per export block; the
port's gradient follows the reference's, which is not the fp32 one, at the
int8 forward's own bound (5e-2). Quant on (4-bit, straight-through):
2e-5 where no code moves, as the forward tests.
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
from repro_torch.core.quant import dequantize_payload, quantize_payload
from repro_torch.dist.halo import build_halo_plan, relocate_node_array
from repro_torch.graph.generators import citation_like, make_dataset
from repro_torch.launch.distributed_gcn import HaloVariant, rank_jobs
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_loss

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K = 4
DIMS = (24, 16, 40)          # layer 1 feature-first, layer 2 aggregation-first
FP32_RTOL, BF16_RTOL, INT8_RTOL = 2e-5, 5e-2, 5e-2
TRAJ_STEPS, TRAJ_LR = 3, 1e-2

V = HaloVariant
VARIANTS = (
    V("seg_fp32", backend="segment"),
    V("seg_fp32_serial_ppermute", backend="segment", overlap=False, via="ppermute"),
    V("seg_bf16", backend="segment", payload="bf16"),
    V("seg_int8", backend="segment", payload="int8"),
    V("bsr_fp32"),
    V("bsr_bf16", payload="bf16"),
    V("bsr_int8_ppermute", payload="int8", via="ppermute"),
    V("bsr_split_fp32", split=True),
    V("bsr_split_bf16_ppermute", split=True, payload="bf16", via="ppermute"),
    V("seg_quant_bf16", backend="segment", payload="bf16", quant=True),
    V("seg_bf16_round_logits", backend="segment", payload="bf16", round_logits=True),
    V("bsr_quant", quant=True),
)
FP32 = [v.name for v in VARIANTS if v.payload is None and not v.quant]


def _inputs():
    """Seeded numpy inputs (tests/test_torch_halo.py's graph), integer
    labels and the training mask: the 3/4 of the nodes whose id is not a
    multiple of 4."""
    g = citation_like(700, 4200, seed=5)
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


def _cora_params():
    spec, _ = make_dataset("cora", reduced=True)
    dims = (spec.n_features, spec.hidden, spec.n_labels)
    r = np.random.default_rng(7)
    return {f"{n}{i}": (r.standard_normal((a, b)) * (2.0 / (a + b)) ** 0.5 if n == "w"
                        else 0.1 * r.standard_normal(b)).astype(np.float32)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])) for n in ("w", "b")}


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={k}"
import sys; sys.path.insert(0, {src!r})
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.partition import partition_graph
from repro.core.quant import QuantConfig
from repro.dist.halo import (build_halo_plan, halo_aggregate, halo_exchange, node_mask, plan_blocked_adjacency,
                             plan_split_blocked_adjacency, relocate_node_array)
from repro.dist.policy import ShardingPolicy
from repro.graph.generators import make_dataset
from repro.models.gcn import GCNConfig, gcn_forward
from repro.train.compression import compressed_psum_mean
from repro.train.loop import Trainer, TrainerConfig
from repro.train.optimizer import adamw

d = np.load({inputs!r})
mesh = jax.make_mesh(({k},), ("model",), axis_types=(jax.sharding.AxisType.Auto,))


def plan_batch(plan, x, labels, mask):
    si, sl, rl, ew = plan.device_arrays()
    return {{"feats": jnp.asarray(relocate_node_array(plan, x)),
            "labels": jnp.asarray(relocate_node_array(plan, labels)),
            "mask": jnp.asarray(mask), "send_idx": si, "senders": sl, "receivers": rl, "edge_w": ew}}


def loss_of(cfg, v):
    # examples/train_distributed_gcn.py's loss_fn, with the variant's policy and tables.
    def loss_fn(params, batch):
        keys = sorted(batch)

        def body(*args):
            b = {{kk: a[0] for kk, a in zip(keys, args)}}
            pol = ShardingPolicy(comm="halo", halo_payload=v["payload"], halo_overlap=v["overlap"],
                                 halo_via=v["via"]).bind_halo(b["send_idx"])
            kw = {{}}
            if v["backend"] == "bsr":
                kw["adjacency"] = (b["t0"], b["t1"], b["t2"])
                if v["split"]:
                    kw["adjacency_boundary"] = (b["t3"], b["t4"], b["t5"])
            logits = gcn_forward(params, b["feats"], b["senders"], b["receivers"], b["edge_w"], cfg, pol, **kw)
            if v.get("round_logits"):
                logits = logits.astype(jnp.bfloat16)
            logits = logits.astype(jnp.float32)
            lse = jax.scipy.special.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, b["labels"][:, None], axis=-1)[:, 0]
            wsum = ((lse - gold) * b["mask"]).sum()
            wcnt = b["mask"].sum()
            loss = jax.lax.psum(wsum, "model") / jnp.maximum(jax.lax.psum(wcnt, "model"), 1.0)
            return loss[None]

        f = jax.shard_map(body, mesh=mesh, in_specs=(P("model"),) * len(keys), out_specs=P("model"),
                          check_vma=False)
        return f(*[batch[kk] for kk in keys]).mean()
    return loss_fn


out = {{}}
ei, w, x = d["edge_index"], d["w"], d["x"]
part = partition_graph(x.shape[0], ei, {k}, method="bfs", seed=0, refine=True)
plan = build_halo_plan(part, ei, w)
batch = plan_batch(plan, x, d["labels"], relocate_node_array(plan, d["mask"]) * node_mask(plan))
comb = plan_blocked_adjacency(plan).device_arrays()
ia, bd = plan_split_blocked_adjacency(plan)
split = ia.device_arrays() + bd.device_arrays()
params = {{n: jnp.asarray(d["p_" + n]) for n in ("w0", "b0", "w1", "b1")}}

# The exchange alone: jax.vjp of halo_exchange inside shard_map, jitted.
zb, ct, si = jnp.asarray(d["z"]), jnp.asarray(d["ct"]), batch["send_idx"]
batch_edges = (batch["senders"], batch["receivers"], batch["edge_w"])
for via in ("all_gather", "ppermute"):
    for payload in ("fp32", "bf16", "int8"):
        def ex(z, s, via=via, payload=payload):
            return halo_exchange(z[0], s[0], "model", via=via, payload=payload)[None]
        f = jax.shard_map(ex, mesh=mesh, in_specs=(P("model"), P("model")), out_specs=P("model"),
                          check_vma=False)
        pull = jax.jit(lambda z, c, f=f: jax.vjp(lambda zz: f(zz, si), z)[1](c)[0])
        out[f"dz_{{via}}_{{payload}}"] = np.asarray(pull(zb, ct))
    for overlap in (False, True):
        def ag(z, s, a, b, c, via=via, overlap=overlap):
            return halo_aggregate(z[0], s[0], a[0], b[0], c[0], "model", via=via, overlap=overlap)[None]
        f = jax.shard_map(ag, mesh=mesh, in_specs=(P("model"),) * 5, out_specs=P("model"), check_vma=False)
        pull = jax.jit(lambda z, c, f=f: jax.vjp(lambda zz: f(zz, si, *batch_edges), z)[1](c)[0])
        out[f"dzagg_{{via}}_{{overlap}}"] = np.asarray(pull(zb, jnp.asarray(d["ct_agg"])))
for payload in (None, "bf16", "int8"):
    def nt(z, s, payload=payload):
        return ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(s[0]).neighbor_table(z[0])[None]
    f = jax.shard_map(nt, mesh=mesh, in_specs=(P("model"),) * 2, out_specs=P("model"), check_vma=False)
    pull = jax.jit(lambda z, c, f=f: jax.vjp(lambda zz: f(zz, si), z)[1](c)[0])
    out[f"dztable_{{payload or 'fp32'}}"] = np.asarray(pull(zb, jnp.asarray(d["ct_table"])))

# The int8 data-parallel mean.
pm = jax.shard_map(lambda v: compressed_psum_mean(v[0], "model")[None], mesh=mesh, in_specs=P("model"),
                   out_specs=P("model"), check_vma=False)
out["psum_mean"] = np.asarray(jax.jit(pm)(jnp.asarray(d["psum_x"])))

# The sharded loss's gradient, every variant.
for v in json.loads(str(d["variants"])):
    cfg = GCNConfig(layer_dims=tuple(d["dims"]), dataflow=v["dataflow"], backend=v["backend"],
                    quant=QuantConfig(enabled=v["quant"]))
    b = dict(batch)
    if v["backend"] == "bsr":
        b.update({{f"t{{i}}": t for i, t in enumerate(split if v["split"] else comb)}})
    loss, grads = jax.jit(jax.value_and_grad(loss_of(cfg, v)))(params, b)
    out["loss_" + v["name"]] = np.asarray(loss)
    for n, g in grads.items():
        out[f"grad_{{v['name']}}_{{n}}"] = np.asarray(g)

# Three AdamW steps of the reference Trainer on the example's loss, reduced Cora.
spec, g = make_dataset("cora", reduced=True)
gs = g.symmetrized().with_self_loops()
cw = gs.sym_normalized_weights()
cpart = partition_graph(gs.n_nodes, gs.edge_index, {k}, method="bfs", seed=0, refine=True)
cplan = build_halo_plan(cpart, gs.edge_index, cw)
cbatch = plan_batch(cplan, g.features.astype(np.float32), g.labels.astype(np.int32), node_mask(cplan))
ccfg = GCNConfig(layer_dims=(spec.n_features, spec.hidden, spec.n_labels))
seg = dict(backend="segment", payload=None, overlap=True, via="all_gather", split=False)
tr = Trainer(loss_of(ccfg, seg), adamw({lr}), {{n: jnp.asarray(d["c_" + n]) for n in ("w0", "b0", "w1", "b1")}},
             TrainerConfig(log_every=100))
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
    plan = build_halo_plan(part, g.edge_index, w)
    r = np.random.default_rng(4)
    z = relocate_node_array(plan, r.standard_normal((g.n_nodes, 12)).astype(np.float32))
    ct = r.standard_normal((K, K * plan.s_max, 12)).astype(np.float32)
    psum_x = r.standard_normal((K, 37, 5)).astype(np.float32)       # 185 elements: padded to 4 chunks
    ct_agg = r.standard_normal((K, plan.n_local, 12)).astype(np.float32)
    ct_table = r.standard_normal((K, plan.n_local + K * plan.s_max, 12)).astype(np.float32)
    return dict(g=g, w=w, x=x, params=params, labels=labels, mask=mask, plan=plan, z=z, ct=ct,
                ct_agg=ct_agg, ct_table=ct_table, psum_x=psum_x, cora_params=_cora_params())


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """(the port's per-rank reports, the reference's outputs): the JAX
    subprocess runs while the port's group does."""
    work = tmp_path_factory.mktemp("halo_train")
    inputs, outputs = work / "inputs.npz", work / "outputs.npz"
    np.savez(inputs, edge_index=case["g"].edge_index, w=case["w"], x=case["x"], dims=np.array(DIMS),
             labels=case["labels"], mask=case["mask"], z=case["z"], ct=case["ct"], psum_x=case["psum_x"],
             ct_agg=case["ct_agg"], ct_table=case["ct_table"],
             variants=json.dumps([dataclasses.asdict(v) for v in VARIANTS]),
             **{f"p_{n}": p for n, p in case["params"].items()},
             **{f"c_{n}": p for n, p in case["cora_params"].items()})
    code = _REFERENCE.format(k=K, src=SRC, inputs=str(inputs), outputs=str(outputs), lr=TRAJ_LR,
                             steps=TRAJ_STEPS)
    ref = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        plan = case["plan"]
        grads = rank_jobs(plan, case["x"], case["params"], DIMS, (), labels=case["labels"], mask=case["mask"],
                          train_variants=VARIANTS)
        spec, g = make_dataset("cora", reduced=True)
        gs = g.symmetrized().with_self_loops()
        cw = gs.sym_normalized_weights()
        cplan = build_halo_plan(partition_graph(gs.n_nodes, gs.edge_index, K, method="bfs", seed=0, refine=True),
                                gs.edge_index, cw)
        traj = rank_jobs(cplan, g.features.astype(np.float32), case["cora_params"],
                         (spec.n_features, spec.hidden, spec.n_labels), (), labels=g.labels,
                         train_variants=(V("cora", backend="segment"),), steps=TRAJ_STEPS, lr=TRAJ_LR,
                         ckpt_dir=str(work / "ckpt"), ckpt_every=1)
        jobs = [{"exchange": {"plan": plan, "z": case["z"][r], "ct": case["ct"][r], "ct_agg": case["ct_agg"][r],
                              "ct_table": case["ct_table"][r]},
                 "psum_mean": case["psum_x"][r], "grads": grads[r],
                 "trajectory": traj[r]} for r in range(K)]
        spec_ = GroupSpec(k=K, backend="gloo", devices=("cpu",), timeout_s=600)
        ranks = run_group(spec_, _torch_halo_ranks.train_grads_and_resume, jobs)
        stdout, stderr = ref.communicate(timeout=900)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert "OK" in stdout, (stdout[-2000:], stderr[-4000:])
    return ranks, dict(np.load(outputs)), work / "ckpt"


def _rel_close(got, want, rtol, what):
    scale = float(np.abs(want).max()) + 1e-30
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


# ------------------------------------------------------------------ exchange
@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("payload", _torch_halo_ranks.PAYLOADS)
def test_exchange_gradient_matches_jax_vjp(runs, via, payload):
    """The cotangent pulled back through the exchange on every rank: the
    transposed collective (reduce-scatter, or the ring in reverse), the
    transposed casts (bf16 crosses back in bf16), and for int8 only the
    scales' pull-back, through amax to one element per export block."""
    ranks, ref, _ = runs
    want = ref[f"dz_{via}_{payload or 'fp32'}"]
    for r, rec in enumerate(ranks):
        got = rec["exchange"]["dz"][via, payload]
        if payload == "int8":
            # Nearly all of it is exactly zero, as in the reference.
            assert np.count_nonzero(got) <= 1 and np.count_nonzero(want[r]) <= 1
        _rel_close(got, want[r], BF16_RTOL if payload == "bf16" else FP32_RTOL, (via, payload, r))


@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("overlap", [False, True])
def test_halo_aggregate_gradient_matches_jax_vjp(runs, via, overlap):
    """`halo_aggregate` differentiates with no code of its own, serialized
    and through `split_halo_aggregate` (overlap): every rank's pull-back
    equals ``jax.vjp`` of the reference's."""
    ranks, ref, _ = runs
    for r, rec in enumerate(ranks):
        _rel_close(rec["exchange"]["dz_agg"][via, overlap], ref[f"dzagg_{via}_{overlap}"][r], FP32_RTOL,
                   (via, overlap, r))


@pytest.mark.parametrize("payload", _torch_halo_ranks.PAYLOADS)
def test_neighbor_table_gradient_matches_jax_vjp(runs, payload):
    """The policy's ``[local ‖ halo]`` table (`halo_block` behind it): the
    local rows' cotangent plus the exchange's pull-back, per wire format."""
    ranks, ref, _ = runs
    for r, rec in enumerate(ranks):
        _rel_close(rec["exchange"]["dz_table"][payload], ref[f"dztable_{payload or 'fp32'}"][r],
                   BF16_RTOL if payload == "bf16" else FP32_RTOL, (payload, r))


def test_exchange_backward_counts_its_wire_rows(case, runs):
    """The backward adds what it moves to ``halo.wire_rows``: the k·s_max
    cotangent rows for fp32 and bf16, none for int8 (only the scales'
    cotangents cross)."""
    ranks, _, _ = runs
    ks = K * case["plan"].s_max
    for rec in ranks:
        for (via, payload), rows in rec["exchange"]["backward_rows"].items():
            assert rows == (0 if payload == "int8" else ks), (via, payload, rows)


def test_amax_splits_ties_as_jnp_max():
    """The int8 codec's gradient: torch's max splits it evenly among tied
    magnitudes, as ``jnp.max`` does, and the codes carry none."""
    jax = pytest.importorskip("jax")
    from repro.core import quant as jq

    x = np.array([[3.0, -1.0], [-3.0, 0.5], [3.0, 2.0]], np.float32)
    ct = np.array([[1.0, 2.0], [0.5, -1.0], [0.25, 3.0]], np.float32)

    def j_loss(v):
        q, s = jq.quantize_payload(v, "int8")
        return (jq.dequantize_payload(q, s) * ct).sum()

    want = np.asarray(jax.grad(j_loss)(jax.numpy.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    q, s = quantize_payload(t, "int8")
    (got,) = torch.autograd.grad((dequantize_payload(q, s) * torch.from_numpy(ct)).sum(), t)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.count_nonzero(want) == 3                       # the three tied |x| = 3 entries


def test_compressed_psum_mean_matches_jax(case, runs):
    """The int8 data-parallel mean on every rank equals the reference's
    (same codes and scales in both phases), and is within the two int8
    roundings of the exact mean."""
    ranks, ref, _ = runs
    exact = case["psum_x"].mean(axis=0)
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["psum_mean"], ref["psum_mean"][r], rtol=0, atol=1e-6)
        assert np.abs(rec["psum_mean"] - exact).max() < 2 * np.abs(case["psum_x"]).max() / 127


# ------------------------------------------------------------------ gradients
def _grads(ranks, name):
    return [rec["grads"][name] for rec in ranks]


@pytest.mark.parametrize("name", [v.name for v in VARIANTS])
def test_sharded_gradient_matches_jax(runs, name):
    """Every rank's gradient of the sharded loss against
    ``jax.jit(jax.value_and_grad)`` of the reference's, and the loss."""
    ranks, ref, _ = runs
    v = next(v for v in VARIANTS if v.name == name)
    rtol = {None: FP32_RTOL, "bf16": BF16_RTOL, "int8": INT8_RTOL}[v.payload]
    for rec in _grads(ranks, name):
        assert rec["finite"]
        np.testing.assert_allclose(rec["loss0"], float(ref[f"loss_{name}"]), rtol=max(rtol, 1e-6))
        for n, g in rec["grads"].items():
            _rel_close(g, ref[f"grad_{name}_{n}"], rtol, (name, n))


def test_replicas_hold_one_gradient(runs):
    """The sharded loss's gradient is the same on every rank (bit for bit:
    the all-reduce hands every rank one sum)."""
    ranks, _, _ = runs
    for v in VARIANTS:
        first = _grads(ranks, v.name)[0]["grads"]
        for rec in _grads(ranks, v.name)[1:]:
            for n, g in rec["grads"].items():
                np.testing.assert_array_equal(g, first[n], err_msg=v.name)


@pytest.mark.parametrize("name", FP32)
def test_fp32_sharded_gradient_equals_unsharded(case, runs, name):
    """Under an fp32 wire the sharded gradient is the unsharded one: the
    port's own loss on the whole graph, same parameters and mask."""
    ranks, _, _ = runs
    g = case["g"]
    ei = torch.from_numpy(g.edge_index)
    leaves = {n: torch.from_numpy(p).requires_grad_(True) for n, p in case["params"].items()}
    loss = gcn_loss(leaves, torch.from_numpy(case["x"]), ei[0], ei[1], torch.from_numpy(case["w"]),
                    torch.from_numpy(case["labels"]), torch.from_numpy(case["mask"]), GCNConfig(layer_dims=DIMS))
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    rec = _grads(ranks, name)[0]
    np.testing.assert_allclose(rec["loss0"], float(loss.detach()), rtol=1e-6)
    for n, grad in rec["grads"].items():
        _rel_close(grad, want[n].numpy(), FP32_RTOL, (name, n))


def test_int8_gradient_is_not_the_fp32_one(runs):
    """No gradient crosses the int8 codes: the int8-wire gradient (equal to
    the reference's above) differs from the fp32-wire one by far more than
    the wire's forward rounding would explain."""
    ranks, ref, _ = runs
    for n in ("w0", "b0"):
        fp32, int8 = ref[f"grad_seg_fp32_{n}"], _grads(ranks, "seg_int8")[0]["grads"][n]
        assert np.abs(int8 - fp32).max() > 0.05 * np.abs(fp32).max(), n


# ------------------------------------------------------------------ training
def test_trainer_trajectory_matches_jax(runs):
    """Three AdamW steps of every rank's Trainer against the reference's
    jitted Trainer on the example's loss (reduced Cora): losses and the
    trained parameters."""
    ranks, ref, _ = runs
    for rec in ranks:
        run = rec["trajectory"]["cora"]
        assert run["steps_run"] == TRAJ_STEPS and not run["resumed"]
        np.testing.assert_allclose(run["losses"], ref["traj_losses"], rtol=2e-5)
        for n, p in run["params"].items():
            _rel_close(p, ref[f"traj_{n}"], 1e-4, n)


def test_checkpoint_written_once_and_resumed_by_every_rank(runs):
    """Rank 0 writes a checkpoint every step; a second run on every rank
    resumes from the last one: the same step and parameters everywhere,
    and no step left to run."""
    ranks, _, ckpt = runs
    assert sorted(os.listdir(ckpt)) == [f"step_{s}" for s in range(1, TRAJ_STEPS + 1)]
    trained = ranks[0]["trajectory"]["cora"]["params"]
    for rec in ranks:
        run = rec["resumed"]["cora"]
        assert run["resumed"] and run["step"] == TRAJ_STEPS and run["steps_run"] == 0
        for n, p in run["params"].items():
            np.testing.assert_array_equal(p, trained[n])
