"""A mutating graph across a 4-rank group, on the CPU: the port's sharded
bsr path on delta-patched rank tables against JAX's unsharded forward.

One `gloo` group of 4 ranks (`repro_torch.launch.mesh.run_group`, spawned
once for the module) runs `repro_torch.launch.distributed_gcn.delta_rank`
through the rank body `_torch_halo_ranks.delta_group`: every rank keeps its
own `DeltaPlanner` replica (flat plan and 2 pods × 2), its own rank tables,
and applies the same pickled deltas made by `mutation_script` on a replica
here — a tile-patch delta, a structural one (the flat pad grows), a
rewiring burst until the `RelocalizePolicy` fires, one delta more, then
`compact`. Checked here:

* at every stage — before any delta, after the tile-patch delta, after
  the structural one, after the re-localization, after `compact` — the
  gathered, restored logits of the flat and the 2 × 2 schedule against the
  reference's unsharded `gcn_forward` (segment backend) on the same edges
  and weights: within 1e-4 of max |logit|;
* every rank's plan checksum and version equal the replica's at every
  stage (the replicas stay identical across processes);
* which path maintained each rank table (patched, then rebuilt on the
  structural delta and the re-localization), each checked rank table
  against a fresh `plan_blocked_rank` tile for tile, and after `compact`
  array-equal to a fresh build at the shared width; the plain kernels'
  checks on the patched table and its NaN-poisoned twin;
* the training losses across the structural delta (3 AdamW steps before
  it, 3 after) against the unsharded port's bsr losses on the same edges
  (relative 1e-4);
* the blocks moved by `relocate_state_tree` bit-equal to the global
  arrays relocated into the new layout.
"""
import numpy as np
import pytest
import torch

import _torch_halo_ranks
from repro_torch.core.partition import partition_graph
from repro_torch.dist.halo import node_mask, relocate_node_array, restore_node_array
from repro_torch.graph.generators import citation_like
from repro_torch.graph.structure import blocked_adjacency
from repro_torch.launch.distributed_gcn import DeltaJob, array_checksum, mutation_script
from repro_torch.launch.mesh import GroupSpec, run_group
from repro_torch.models.gcn import GCNConfig, gcn_loss
from repro_torch.train.loop import Trainer, TrainerConfig
from repro_torch.train.optimizer import adamw

K = 4
DIMS = (24, 16, 40)          # layer 1 feature-first, layer 2 aggregation-first
LOGIT_RTOL = 1e-4
LOSS_RTOL = 1e-4
STEPS = (3, 3)               # AdamW steps after the tile-patch delta, after the structural one
LR = 1e-2
POLICY = dict(threshold=1.05, patience=2, cooldown=3, block=32)
STAGES = ("v0", "delta1", "delta2", "relocalized", "compact")


def _inputs():
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
    labels = g.labels.astype(np.int64) % DIMS[-1]
    mask = (np.arange(g.n_nodes) % 3 != 0).astype(np.float32)
    return g, w, x, params, labels, mask


@pytest.fixture(scope="module")
def run():
    g, w, x, params, labels, mask = _inputs()
    part = partition_graph(g.n_nodes, g.edge_index, K, method="bfs", seed=0, refine=True)
    script = mutation_script(part, g.edge_index, w, seed=3, patch_ops=16, members=12, max_edges=40,
                             policy=POLICY, max_burst=40, graph_key="delta-test")
    layout0 = script["stages"]["v0"]["layout"]
    xb = relocate_node_array(layout0, x)
    lb = relocate_node_array(layout0, labels)
    mb = relocate_node_array(layout0, mask) * node_mask(layout0)
    jobs = [DeltaJob(part=part, edge_index=g.edge_index, w=w, x=xb[r], labels=lb[r], mask=mb[r],
                     params=params, layer_dims=DIMS, deltas=script["deltas"], train_steps=STEPS, lr=LR,
                     pods=2, policy=POLICY, burst=script["burst"], graph_key="delta-test")
            for r in range(K)]
    results = run_group(GroupSpec(k=K, backend="gloo", devices=("cpu",), timeout_s=600.0),
                        _torch_halo_ranks.delta_group, jobs)
    return dict(g=g, w=w, x=x, params=params, labels=labels, mask=mask, script=script, results=results)


def _stage(results, name):
    return [next(s for s in r["stages"] if s["name"] == name) for r in results]


def _jax_forward(params, x, ei, w):
    import jax.numpy as jnp

    from repro.models.gcn import GCNConfig as RConfig
    from repro.models.gcn import gcn_forward

    cfg = RConfig(layer_dims=DIMS)
    p = {n: jnp.asarray(v) for n, v in params.items()}
    return np.asarray(gcn_forward(p, jnp.asarray(x), jnp.asarray(ei[0]), jnp.asarray(ei[1]),
                                  jnp.asarray(w), cfg))


def test_stages_ran_in_order(run):
    for r in run["results"]:
        assert [s["name"] for s in r["stages"]] == list(STAGES)
    assert run["results"][0]["pod_groups"] == [[0, 2], [0, 1]]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("schedule", ("flat", "hier"))
def test_sharded_forward_matches_jax_unsharded(run, stage, schedule):
    st = run["script"]["stages"][stage]
    recs = _stage(run["results"], stage)
    got = restore_node_array(st["layout"], np.stack([rec["logits"][schedule] for rec in recs]))
    ref = _jax_forward(run["params"], run["x"], st["edge_index"], st["w"])
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= LOGIT_RTOL * np.abs(ref).max()


def test_edges_change_between_stages(run):
    """The deltas are strong enough to show: each stage's unsharded
    logits differ from the previous stage's."""
    stages = run["script"]["stages"]
    refs = [_jax_forward(run["params"], run["x"], stages[s]["edge_index"], stages[s]["w"])
            for s in ("v0", "delta1", "delta2", "relocalized")]
    for a, b in zip(refs, refs[1:]):
        assert np.abs(a - b).max() > 1e-4


@pytest.mark.parametrize("stage", STAGES)
def test_replicas_agree(run, stage):
    recs = _stage(run["results"], stage)
    st = run["script"]["stages"][stage]
    assert {rec["checksum"] for rec in recs} == {st["checksum"]}
    assert {rec["version"] for rec in recs} == {st["version"]}


def test_table_maintenance_paths(run):
    reps = run["script"]["reports"]
    assert not reps[0]["structural"] and reps[1]["structural"]
    d1, d2 = _stage(run["results"], "delta1"), _stage(run["results"], "delta2")
    paths1 = [rec["tables"]["flat"]["last"] for rec in d1] + [rec["tables"]["hier"]["last"] for rec in d1]
    assert set(paths1) <= {"patched", "unchanged"} and "patched" in paths1
    assert all(rec["tables"]["flat"]["last"] == "rebuilt" for rec in d2)
    for rec in _stage(run["results"], "relocalized"):
        assert rec["tables"]["flat"]["last"] == rec["tables"]["hier"]["last"] == "rebuilt"
    # the ranks' own reports count their table patches; the structural flags are the replica's
    for r in run["results"]:
        assert [rep["structural"] for rep in r["reports"]] == [rep["structural"] for rep in reps]
        assert r["reports"][0]["blocked_patched"] > 0
        assert r["reports"][1]["blocked_dropped"] >= 1


@pytest.mark.parametrize("stage", STAGES)
def test_checked_rank_tables_equal_fresh_builds(run, stage):
    rec = _stage(run["results"], stage)[0]
    assert rec["table_check"]["flat"]["same"] and rec["table_check"]["hier"]["same"]
    assert all("table_check" not in s for s in _stage(run["results"], stage)[1:])


@pytest.mark.parametrize("stage", ("delta1", "delta2"))
def test_patched_table_kernel_checks(run, stage):
    rec = _stage(run["results"], stage)[0]
    names = {"k2_ff_transform", "k2_ff_aggregate", "k2_af_layer", "k1_bsr_spmm"}
    assert names <= set(rec["kernels"])
    assert all(c["ok"] for c in rec["kernels"].values()), rec["kernels"]
    for n in names - {"k2_ff_transform"}:
        assert rec["kernels"][f"{n} (poisoned padding)"]["finite"]


def test_training_across_structural_delta_matches_unsharded(run):
    stages = run["script"]["stages"]
    cfg = GCNConfig(layer_dims=DIMS, backend="bsr")
    g = run["g"]
    x = torch.from_numpy(run["x"])
    labels = torch.from_numpy(run["labels"])
    mask = torch.from_numpy(run["mask"])

    def batch(st):
        ba = blocked_adjacency(g.n_nodes, st["edge_index"], st["w"])
        ei = torch.from_numpy(st["edge_index"].astype(np.int64))
        return {"s": ei[0], "r": ei[1], "w": torch.from_numpy(st["w"]), "adj": ba.arrays(device="cpu")}

    def loss(p, b):
        return gcn_loss(p, x, b["s"], b["r"], b["w"], labels, mask, cfg, adjacency=b["adj"])

    tr = Trainer(loss, adamw(LR), {n: torch.from_numpy(v) for n, v in run["params"].items()},
                 TrainerConfig(log_every=1 << 30))
    ref = []
    for name, steps in zip(("delta1", "delta2"), STEPS):
        b = batch(stages[name])
        ref += tr.fit(iter(lambda: b, None), max_steps=tr.step + steps)
    for r in run["results"]:
        got = [v for t in r["train"] for v in t["losses"]]
        assert len(got) == sum(STEPS)
        assert max(abs(a - b) / abs(b) for a, b in zip(got, ref)) <= LOSS_RTOL


def test_relocalize_fired_and_moved_state_bit_exact(run):
    script = run["script"]
    fired = [rep for rep in script["reports"] if rep["relocalized"] is not None]
    assert len(fired) == 1
    rel = fired[0]["relocalized"]
    assert rel["executed_tiles_after"] < rel["executed_tiles_before"]
    layout = script["stages"]["relocalized"]["layout"]
    want = {"x": relocate_node_array(layout, run["x"]),
            "labels": relocate_node_array(layout, run["labels"]),
            "mask": relocate_node_array(layout, run["mask"]) * node_mask(layout)}
    for rank, r in enumerate(run["results"]):
        assert r["moved"] == {k: array_checksum(v[rank].astype(r_dtype))
                              for (k, v), r_dtype in zip(want.items(), (np.float32, np.int64, np.float32))}


def test_compact_then_tables_fresh(run):
    assert run["script"]["compact"]["changed"]
    for r in run["results"]:
        assert r["compact"]["changed"] == run["script"]["compact"]["changed"]
        assert r["compact"]["version"] == run["script"]["stages"]["compact"]["version"]
