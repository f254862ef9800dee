"""The halo branches of PNA, EGNN, GraphCast and EquiformerV2 on a 4-rank
gloo group.

One group (`repro_torch.launch.mesh.run_group`, spawned once for the
module) runs `repro_torch.launch.gnn_halo.gnn_halo_rank` on every rank:
each model's sharded forward over a `HaloPlan` with the fp32 and the bf16
wire. The restored rows hold against the port's unsharded forward of the
same inputs — fp32 within 1e-3 of max |unsharded|; PNA under the bf16
wire at the reference's own gate (tests/test_overlap_halo.py:352-385:
5e-2 max-abs and 1e-2 relative L2) — and the unsharded forwards hold
against the JAX package's within 1e-5 of max. Each rank's wire
accounting equals the plan's: one exchange a layer of ``k·s_max`` rows
(GraphCast and EquiformerV2 add one of the positions, GraphCast's always
fp32, EquiformerV2's in the wire format as the reference's model sends
it); EquiformerV2's rows are its whole (l_max+1)² × C irreps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import egnn as ref_egnn
from repro.models import equiformer_v2 as ref_eq
from repro.models import graphcast as ref_gc
from repro.models import pna as ref_pna
from repro_torch.core.partition import partition_graph
from repro_torch.dist.halo import build_halo_plan, restore_node_array
from repro_torch.graph.generators import citation_like
from repro_torch.launch.gnn_halo import gnn_forward, gnn_halo_jobs, gnn_halo_rank
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models import egnn, equiformer_v2, graphcast, pna
from repro_torch.nn.layers import params_from_numpy

K = 4
FP32_TOL = 1e-3
BF16_ABS, BF16_REL = 5e-2, 1e-2
D_IN = 16
CONFIGS = {
    "pna": (pna.PNAConfig(n_layers=2, d_hidden=32, d_in=D_IN, d_out=3), ref_pna.PNAConfig,
            ref_pna.pna_init),
    "egnn": (egnn.EGNNConfig(n_layers=2, d_hidden=16, d_in=D_IN, d_out=3), ref_egnn.EGNNConfig,
             ref_egnn.egnn_init),
    "graphcast": (graphcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=3, mesh_refinement=1, d_in=D_IN),
                  ref_gc.GraphCastConfig, ref_gc.graphcast_init),
    "equiformer-v2": (equiformer_v2.EquiformerV2Config(n_layers=2, d_hidden=8, l_max=2, m_max=1, n_heads=2, d_in=D_IN,
                                                       d_out=3), ref_eq.EquiformerV2Config, ref_eq.equiformer_init),
}


def _inputs():
    g = citation_like(700, 4200, seed=5)
    r = np.random.default_rng(1)
    x = r.standard_normal((g.n_nodes, D_IN)).astype(np.float32)
    pos = r.standard_normal((g.n_nodes, 3)).astype(np.float32)
    params = {}
    for i, (arch, (cfg, ref_cfg, init)) in enumerate(CONFIGS.items()):
        params[arch] = jax.tree.map(np.asarray, init(jax.random.PRNGKey(i + 1), ref_cfg(**dataclasses.asdict(cfg))))
    return g, x, pos, params


@pytest.fixture(scope="module")
def run():
    g, x, pos, params = _inputs()
    part = partition_graph(g.n_nodes, g.edge_index, K, method="bfs", seed=0, refine=True)
    plan = build_halo_plan(part, g.edge_index)
    models = [(arch, CONFIGS[arch][0], params[arch]) for arch in CONFIGS]
    spec = GroupSpec(k=K, backend="gloo", devices=("cpu",), timeout_s=600)
    results = run_group(spec, gnn_halo_rank, gnn_halo_jobs(plan, x, pos, models))
    return g, x, pos, params, plan, results


def _unsharded(arch, g, x, pos, params):
    s, r = torch.from_numpy(g.edge_index[0]), torch.from_numpy(g.edge_index[1])
    with torch.inference_mode():
        return gnn_forward(arch, params_from_numpy(params[arch], "cpu"), CONFIGS[arch][0], torch.from_numpy(x),
                           torch.from_numpy(pos), s, r).numpy()


def _restored(plan, results, key):
    return restore_node_array(plan, np.stack([res[key]["rows"] for res in results]))


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_unsharded_forward_matches_jax(run, arch):
    g, x, pos, params, _, _ = run
    cfg, ref_cfg, _ = CONFIGS[arch]
    rcfg = ref_cfg(**dataclasses.asdict(cfg))
    s, r = jnp.asarray(g.edge_index[0]), jnp.asarray(g.edge_index[1])
    jp = jax.tree.map(jnp.asarray, params[arch])
    if arch == "pna":
        theirs = ref_pna.pna_forward(jp, jnp.asarray(x), s, r, rcfg)
    elif arch == "egnn":
        theirs = ref_egnn.egnn_forward(jp, jnp.asarray(x), jnp.asarray(pos), s, r, rcfg)[0]
    elif arch == "equiformer-v2":
        theirs = ref_eq.equiformer_forward(jp, jnp.asarray(x), jnp.asarray(pos), s, r, rcfg)
    else:
        rel = pos[g.edge_index[1]] - pos[g.edge_index[0]]
        ef = np.concatenate([rel, np.linalg.norm(rel, axis=1, keepdims=True)], 1).astype(np.float32)
        theirs = ref_gc.graphcast_forward(jp, jnp.asarray(x), jnp.asarray(ef), s, r, rcfg)
    theirs = np.asarray(theirs)
    ours = _unsharded(arch, g, x, pos, params)
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_fp32_wire_matches_unsharded(run, arch):
    g, x, pos, params, plan, results = run
    ref = _unsharded(arch, g, x, pos, params)
    out = _restored(plan, results, f"{arch}/fp32")
    assert all(res[f"{arch}/fp32"]["finite"] for res in results)
    assert np.abs(out - ref).max() <= FP32_TOL * np.abs(ref).max()


def test_pna_bf16_wire_within_the_reference_gate(run):
    g, x, pos, params, plan, results = run
    ref = _unsharded("pna", g, x, pos, params)
    out = _restored(plan, results, "pna/bf16")
    err = np.abs(out - ref).max()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert err < BF16_ABS and rel < BF16_REL, (err, rel)


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_wire_accounting_per_rank(run, arch):
    """One exchange a layer of k·s_max rows of the layer's width (GraphCast
    one more, of the 3 position columns in fp32); bf16 halves the bytes."""
    _, _, _, _, plan, results = run
    cfg = CONFIGS[arch][0]
    rows = plan.k * plan.s_max
    extra = 1 if arch in ("graphcast", "equiformer-v2") else 0
    if arch == "equiformer-v2":
        assert results[0][f"{arch}/fp32"]["exchange_width"] == (cfg.l_max + 1) ** 2 * cfg.d_hidden
    for res in results:
        fp32, bf16 = res[f"{arch}/fp32"], res[f"{arch}/bf16"]
        assert fp32["exchanges"] == bf16["exchanges"] == cfg.n_layers + extra
        assert fp32["wire_rows"] == bf16["wire_rows"] == rows * (cfg.n_layers + extra)
        width = fp32["exchange_width"]
        pos_bytes = extra * rows * 3 * 4
        assert fp32["wire_bytes"] == rows * width * 4 * cfg.n_layers + pos_bytes
        bf16_pos = pos_bytes / 2 if arch == "equiformer-v2" else pos_bytes
        assert bf16["wire_bytes"] == rows * width * 2 * cfg.n_layers + bf16_pos
        assert fp32["wire_bytes_per_layer"] == rows * width * 4 == 2 * bf16["wire_bytes_per_layer"]
