"""The port's sharded (halo) path against the JAX package's, on the CPU.

One 4-rank `gloo` group (`repro_torch.launch.mesh.run_group`, spawned once
for the module) runs, on every rank, the raw exchange — `halo_exchange`
for both lowerings (``all_gather`` and the ``ppermute`` send/recv ring) and
each wire format, `halo_aggregate` serialized and overlapped — and then
the port's sharded `gcn_forward` in every variant below. One subprocess
(also once for the module) runs the reference's halo forward in the same
variants inside ``shard_map`` on 4 emulated host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), as
tests/test_overlap_halo.py does with 8.

Tolerances, from ROADMAP.md's parity contract:

* the exchange: exact (fp32 and bf16 rows are copies; int8 codes are the
  same arithmetic) against the numpy emulation of
  tests/test_overlap_halo.py:32-35; aggregates 2e-5 (summation order);
* the forward, port against reference: 3e-4 in fp32; 5e-2 under a bf16
  wire (bf16 rounds rows and, on the fused aggregation-first layer, the
  output); under an int8 wire the reference's own int8 bound
  (tests/test_overlap_halo.py:243-250: 5e-2 max-abs and 1e-2 relative L2),
  since one fp32 summation-order difference can move an int8 code by a
  step; quant on (4-bit): 3e-4 where no 4-bit code moves, as in
  tests/test_torch_gcn.py.
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
from repro_torch.core.quant import QuantConfig
from repro_torch.dist.halo import build_halo_plan, relocate_node_array, restore_node_array
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.generators import citation_like
from repro_torch.launch.distributed_gcn import HaloVariant, rank_jobs
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_forward

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
K = 4
DIMS = (24, 16, 40)          # layer 1 feature-first (16 < 24), layer 2 aggregation-first
FP32_TOL, BF16_TOL = 3e-4, 5e-2
INT8_ABS, INT8_REL = 5e-2, 1e-2

V = HaloVariant
VARIANTS = (
    V("seg_fp32", backend="segment"),
    V("seg_fp32_serial", backend="segment", overlap=False),
    V("seg_bf16", backend="segment", payload="bf16"),
    V("seg_int8", backend="segment", payload="int8"),
    V("seg_ppermute", backend="segment", overlap=False, via="ppermute"),
    V("bsr_fp32"),
    V("bsr_bf16", payload="bf16"),
    V("bsr_int8", payload="int8"),
    V("bsr_split_fp32", split=True),
    V("bsr_split_bf16", split=True, payload="bf16"),
    V("bsr_split_int8_ppermute", split=True, payload="int8", via="ppermute"),
    V("bsr_ff", dataflow="feature_first"),
    V("bsr_af_bf16", dataflow="aggregation_first", payload="bf16"),
    V("seg_quant_bf16", backend="segment", payload="bf16", quant=True),
    V("bsr_quant_bf16", payload="bf16", quant=True),
    V("bsr_split_quant", split=True, quant=True),
)


def _inputs():
    """Seeded numpy inputs (the prelude of tests/test_overlap_halo.py at
    4 ranks): a homophilous graph with receiver-normalized weights, 24-wide
    features, and parameters with nonzero biases."""
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
    return g, w, x, params


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={k}"
import sys; sys.path.insert(0, {src!r})
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core.partition import partition_graph
from repro.core.quant import QuantConfig
from repro.dist.halo import (build_halo_plan, plan_blocked_adjacency,
                             plan_split_blocked_adjacency, relocate_node_array, restore_node_array)
from repro.dist.policy import ShardingPolicy
from repro.models.gcn import GCNConfig, gcn_forward

d = np.load({inputs!r})
variants = json.loads(str(d["variants"]))
ei, w, x = d["edge_index"], d["w"], d["x"]
params = {{n: jnp.asarray(d["p_" + n]) for n in json.loads(str(d["param_names"]))}}
part = partition_graph(x.shape[0], ei, {k}, method="bfs", seed=0, refine=True)
plan = build_halo_plan(part, ei, w)
mesh = jax.make_mesh(({k},), ("model",))
base = (jnp.asarray(relocate_node_array(plan, x)),) + tuple(plan.device_arrays())
comb = plan_blocked_adjacency(plan).device_arrays()
ia, bd = plan_split_blocked_adjacency(plan)
split = ia.device_arrays() + bd.device_arrays()
out = {{}}
for v in variants:
    cfg = GCNConfig(layer_dims=tuple(d["dims"]), dataflow=v["dataflow"], backend=v["backend"],
                    quant=QuantConfig(enabled=v["quant"]))
    pol0 = ShardingPolicy(comm="halo", halo_payload=v["payload"], halo_overlap=v["overlap"],
                          halo_via=v["via"])
    tabs = () if v["backend"] != "bsr" else (split if v["split"] else comb)

    def body(fe, a, b, c, e, *t, cfg=cfg, pol0=pol0, v=v):
        kw = {{}}
        if v["backend"] == "bsr":
            kw["adjacency"] = (t[0][0], t[1][0], t[2][0])
            if v["split"]:
                kw["adjacency_boundary"] = (t[3][0], t[4][0], t[5][0])
        h = gcn_forward(params, fe[0], b[0], c[0], e[0], cfg, pol0.bind_halo(a[0]), **kw)
        return h.astype(jnp.float32)[None]

    ins = base + tabs
    f = jax.shard_map(body, mesh=mesh, in_specs=(P("model"),) * len(ins), out_specs=P("model"),
                      check_vma=False)
    out[v["name"]] = restore_node_array(plan, np.asarray(f(*ins)))
np.savez({outputs!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def case():
    g, w, x, params = _inputs()
    part = partition_graph(g.n_nodes, g.edge_index, K, method="bfs", seed=0, refine=True)
    plan = build_halo_plan(part, g.edge_index, w)
    return dict(g=g, w=w, x=x, params=params, plan=plan)


@pytest.fixture(scope="module")
def reference(case, tmp_path_factory):
    """The JAX package's halo forward of every variant, restored to global
    node order (one subprocess)."""
    work = tmp_path_factory.mktemp("halo_ref")
    inputs, outputs = work / "inputs.npz", work / "outputs.npz"
    np.savez(inputs, edge_index=case["g"].edge_index, w=case["w"], x=case["x"], dims=np.array(DIMS),
             variants=json.dumps([dataclasses.asdict(v) for v in VARIANTS]),
             param_names=json.dumps(sorted(case["params"])),
             **{f"p_{n}": p for n, p in case["params"].items()})
    code = _REFERENCE.format(k=K, src=SRC, inputs=str(inputs), outputs=str(outputs))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    assert "OK" in out.stdout, (out.stdout[-2000:], out.stderr[-4000:])
    return dict(np.load(outputs))


@pytest.fixture(scope="module")
def group(case):
    """The port's 4-rank gloo group: exchange checks and every variant's
    sharded forward, per rank (one spawned group)."""
    plan = case["plan"]
    jobs = rank_jobs(plan, case["x"], case["params"], DIMS, VARIANTS)
    zb = relocate_node_array(plan, np.random.default_rng(3).standard_normal((plan.n_nodes, 12)).astype(np.float32))
    spec = GroupSpec(k=K, backend="gloo", devices=("cpu",), timeout_s=600)
    return run_group(spec, _torch_halo_ranks.exchange_and_forward,
                     [{"z": zb[r], "forward": jobs[r]} for r in range(K)]), zb


def _restored(case, group, name):
    ranks, _ = group
    return restore_node_array(case["plan"], np.stack([r["forward"]["variants"][name]["logits"] for r in ranks]))


# ------------------------------------------------------------------ exchange
def _emulated_halo(plan, zb, payload):
    """Numpy emulation of the flat halo block: every rank's export rows in
    rank order, each sender's block through the wire format."""
    blocks = []
    for m in range(plan.k):
        rows = zb[m][plan.send_idx[m]]
        if payload == "bf16":
            rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
        elif payload == "int8":
            amax = np.abs(rows).max()
            scale = np.float32(amax / np.float32(127.0)) if amax > 0 else np.float32(1.0)
            rows = np.clip(np.round(rows / scale), -127, 127).astype(np.float32) * scale
        blocks.append(rows)
    return np.concatenate(blocks)


@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("payload", _torch_halo_ranks.PAYLOADS)
def test_halo_exchange_equals_numpy_emulation(case, group, via, payload):
    """Slot j·s_max + t holds row send_idx[j, t] of rank j, on every rank,
    for both lowerings and every wire format."""
    ranks, zb = group
    plan = case["plan"]
    want = _emulated_halo(plan, zb, payload)
    assert want.shape == (plan.k * plan.s_max, zb.shape[-1])
    for r in ranks:
        got = r["halo"][via, payload]
        assert got.dtype == np.float32
        if payload == "int8":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("via", _torch_halo_ranks.VIAS)
@pytest.mark.parametrize("overlap", [False, True])
def test_halo_aggregate_equals_numpy_emulation(case, group, via, overlap):
    """The combined [local ‖ halo] gather and the interior/boundary split
    both equal the numpy aggregation over the plan's edges."""
    ranks, zb = group
    plan = case["plan"]
    halo = _emulated_halo(plan, zb, None)
    for dev, r in enumerate(ranks):
        table = np.concatenate([zb[dev], halo])
        ref = np.zeros_like(zb[dev])
        np.add.at(ref, plan.receivers_l[dev], table[plan.senders_l[dev]] * plan.edge_w[dev][:, None])
        np.testing.assert_allclose(r["aggregate"][via, overlap], ref, atol=2e-5)


# ------------------------------------------------------------------- forward
def _tolerance_check(name, out, ref):
    if "int8" in name:
        err = np.abs(out - ref).max()
        rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
        assert err < INT8_ABS and rel < INT8_REL, (name, err, rel)
    else:
        tol = BF16_TOL if "bf16" in name else FP32_TOL
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", [v.name for v in VARIANTS])
def test_sharded_forward_matches_jax_halo_forward(case, reference, group, name):
    """4 gloo ranks against 4 emulated devices, same inputs and parameters."""
    out = _restored(case, group, name)
    assert out.shape == (case["g"].n_nodes, DIMS[-1]) and np.isfinite(out).all()
    _tolerance_check(name, out, reference[name])


@pytest.mark.parametrize("name", [v.name for v in VARIANTS if not v.quant])
def test_sharded_forward_matches_unsharded_port(case, group, name):
    """Each quant-off variant against the port's own unsharded segment
    forward on the global graph (the reference's 1e-4 / 1e-2 / int8 bounds,
    tests/test_overlap_halo.py:238-250)."""
    g = case["g"]
    v = next(v for v in VARIANTS if v.name == name)
    cfg = GCNConfig(layer_dims=DIMS, dataflow=v.dataflow)
    params = {n: torch.from_numpy(p) for n, p in case["params"].items()}
    ei = torch.from_numpy(g.edge_index)
    ref = gcn_forward(params, torch.from_numpy(case["x"]), ei[0], ei[1], torch.from_numpy(case["w"]),
                      cfg, NO_POLICY).numpy()
    out = _restored(case, group, name)
    if v.payload == "int8":
        _tolerance_check(name, out, ref)
    else:
        assert np.abs(out - ref).max() < (1e-2 if v.payload == "bf16" else 1e-4), name


def test_every_rank_reports_wire_rows_dtypes_and_no_launch(case, group):
    """Each forward receives n_layers · k·s_max rows per rank (the plan's
    halo contract), a fused bf16 layer returns bf16 logits as the
    reference's does, and on the CPU no CUDA kernel launches."""
    ranks, _ = group
    plan = case["plan"]
    for r in ranks:
        for v in VARIANTS:
            rec = r["forward"]["variants"][v.name]
            assert rec["wire_rows"] == (len(DIMS) - 1) * plan.k * plan.s_max, v.name
            assert rec["launches"] == {} and rec["finite"]
            fused_bf16 = v.backend == "bsr" and v.payload == "bf16" and not v.split
            assert rec["dtype"] == ("bfloat16" if fused_bf16 else "float32"), v.name


# ---------------------------------------------------------------- validation
def test_policy_binds_flat_and_refuses_the_hierarchical_pair():
    """bind_halo's argument errors are the reference's. The hierarchical
    pair, once refused, now binds as the reference's does; what the port
    still refuses is exchanging it without the rank's (pod, model) groups."""
    pol = ShardingPolicy(comm="halo")
    idx = torch.zeros(3, dtype=torch.int32)
    assert not pol.is_halo and pol.bind_halo(idx).is_halo
    assert not ShardingPolicy().bind_halo(idx).is_halo          # broadcast stays unarmed
    x = torch.ones(5, 2)
    assert NO_POLICY.neighbor_table(x) is x and NO_POLICY.constrain(x, "node_hidden") is x
    with pytest.raises(ValueError, match="not both"):
        pol.bind_halo(idx, send_loc=idx, send_rem=idx)
    with pytest.raises(ValueError, match="BOTH"):
        pol.bind_halo(send_loc=idx)
    with pytest.raises(ValueError, match="needs send_idx"):
        pol.bind_halo()
    hier = pol.bind_halo(send_loc=idx, send_rem=idx)
    assert hier.is_halo and not pol.is_halo and hier.halo_send_idx is None
    with pytest.raises(ValueError, match="halo_groups"):
        hier.neighbor_table(x)


def test_gcn_halo_argument_validation(case):
    """The halo errors of src/repro/models/gcn.py:152-163."""
    g = case["g"]
    x = torch.from_numpy(case["x"])
    ei = torch.from_numpy(g.edge_index)
    params = {n: torch.from_numpy(p) for n, p in case["params"].items()}
    args = (params, x, ei[0], ei[1], torch.from_numpy(case["w"]))
    armed = ShardingPolicy(comm="halo").bind_halo(torch.zeros(1, dtype=torch.int32))
    tab = (torch.zeros((1, 1, 128, 128)), torch.zeros((1, 1), dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="adjacency_boundary"):
        gcn_forward(*args, GCNConfig(layer_dims=DIMS, backend="bsr"), adjacency=tab, adjacency_boundary=tab)
    with pytest.raises(ValueError, match="adjacency_boundary"):
        gcn_forward(*args, GCNConfig(layer_dims=DIMS), armed, adjacency_boundary=tab)
    with pytest.raises(ValueError, match="cannot run per-shard"):
        gcn_forward(*args, GCNConfig(layer_dims=DIMS, backend="dense"), armed, dense_adj=torch.zeros(1))


def test_quant_on_calibrates_per_rank(case, group):
    """With quant on each rank calibrates fake quant on its own block,
    padding rows included (the reference inside shard_map): the sharded
    quant-on forward differs from the unsharded one, which calibrates once
    on the whole graph."""
    g = case["g"]
    cfg = GCNConfig(layer_dims=DIMS, quant=QuantConfig())
    params = {n: torch.from_numpy(p) for n, p in case["params"].items()}
    ei = torch.from_numpy(g.edge_index)
    unsharded = gcn_forward(params, torch.from_numpy(case["x"]), ei[0], ei[1], torch.from_numpy(case["w"]),
                            cfg).numpy()
    assert np.abs(_restored(case, group, "seg_quant_bf16") - unsharded).max() > 1e-3
