"""The rank bodies of the process groups of tests/test_torch_halo.py,
tests/test_torch_halo_train.py, tests/test_torch_hier_halo.py,
tests/test_torch_delta_group.py and tests/test_torch_equiformer.py.

The spawned ranks import this module by name (the test directory is on
their path), so it imports neither JAX nor `repro`: only torch, numpy and
`repro_torch`. One call per rank runs the raw exchange checks and then the
sharded forwards of `repro_torch.launch.distributed_gcn.halo_rank`, or the
exchange's gradients and the training runs of `halo_train_rank`.
"""
import torch

from repro_torch.dist.halo import halo_aggregate, halo_exchange
from repro_torch.launch.distributed_gcn import halo_rank

PAYLOADS = (None, "bf16", "int8")
VIAS = ("all_gather", "ppermute")


def exchange_and_forward(rank: int, k: int, device: torch.device, job: dict) -> dict:
    """``job``: ``z`` (n_local, d) this rank's block of a test matrix, and
    ``forward``, a `RankJob`. Returns the halo blocks per (lowering, wire
    format), the aggregates per (lowering, overlap), and `halo_rank`'s
    report."""
    plan = job["forward"].plan
    send_idx, senders, receivers, edge_w = plan.rank_arrays(rank, device)
    z = torch.from_numpy(job["z"]).to(device)
    out = {"halo": {}, "aggregate": {}}
    for via in VIAS:
        for payload in PAYLOADS:
            out["halo"][via, payload] = halo_exchange(z, send_idx, via=via, payload=payload).numpy()
        for overlap in (False, True):
            out["aggregate"][via, overlap] = halo_aggregate(
                z, send_idx, senders, receivers, edge_w, via=via, overlap=overlap).numpy()
    out["forward"] = halo_rank(rank, k, device, job["forward"])
    return out


def fail_on_rank(rank: int, k: int, device: torch.device, arg: int) -> int:
    """Raise on rank ``arg``; return the rank elsewhere."""
    if rank == arg:
        raise ValueError(f"planned failure on rank {rank}")
    return rank


def exchange_grads(rank: int, device: torch.device, job: dict) -> dict:
    """Cotangents pulled back to ``job["z"]``: ``job["ct"]`` through
    `halo_exchange` per (lowering, wire format), with the wire rows the
    backward adds to ``halo.wire_rows``; ``job["ct_agg"]`` through
    `halo_aggregate` per (lowering, overlap: `split_halo_aggregate`); and
    ``job["ct_table"]`` through the policy's `neighbor_table` per wire
    format."""
    from repro_torch.dist.policy import ShardingPolicy
    from repro_torch.obs import metrics

    send_idx, senders, receivers, edge_w = job["plan"].rank_arrays(rank, device)
    ct, ct_agg, ct_table = (torch.from_numpy(job[k]).to(device) for k in ("ct", "ct_agg", "ct_table"))

    def z():
        return torch.from_numpy(job["z"]).to(device).requires_grad_(True)

    out = {"dz": {}, "backward_rows": {}, "dz_agg": {}, "dz_table": {}}
    for via in VIAS:
        for payload in PAYLOADS:
            zz = z()
            halo = halo_exchange(zz, send_idx, via=via, payload=payload)
            registry = metrics.enable(metrics.MetricsRegistry())
            (dz,) = torch.autograd.grad(halo, zz, ct)
            out["backward_rows"][via, payload] = int(registry.counter("halo.wire_rows").value)
            metrics.disable()
            out["dz"][via, payload] = dz.numpy()
        for overlap in (False, True):
            zz = z()
            agg = halo_aggregate(zz, send_idx, senders, receivers, edge_w, via=via, overlap=overlap)
            out["dz_agg"][via, overlap] = torch.autograd.grad(agg, zz, ct_agg)[0].numpy()
    for payload in PAYLOADS:
        zz = z()
        table = ShardingPolicy(comm="halo", halo_payload=payload).bind_halo(send_idx).neighbor_table(zz)
        out["dz_table"][payload] = torch.autograd.grad(table, zz, ct_table)[0].numpy()
    return out


def train_grads_and_resume(rank: int, k: int, device: torch.device, job: dict) -> dict:
    """tests/test_torch_halo_train.py's rank body: the exchange's gradients,
    `compressed_psum_mean` of ``job["psum_mean"]`` (fp32) and of ``job["psum_mean_bf16"]`` (cast to bf16),
    the first gradient of every training variant (``job["grads"]``, a
    `RankJob` with no steps), a short training run that checkpoints
    (``job["trajectory"]``), then the same job again, which resumes."""
    from repro_torch.launch.distributed_gcn import halo_train_rank

    from repro_torch.train.compression import compressed_psum_mean

    return {"exchange": exchange_grads(rank, device, job["exchange"]),
            "psum_mean": compressed_psum_mean(torch.from_numpy(job["psum_mean"]).to(device)).cpu().numpy(),
            "psum_mean_bf16": compressed_psum_mean(
                torch.from_numpy(job["psum_mean_bf16"]).to(device, torch.bfloat16)).cpu().numpy(),
            "grads": halo_train_rank(rank, k, device, job["grads"])["train"],
            "trajectory": halo_train_rank(rank, k, device, job["trajectory"])["train"],
            "resumed": halo_train_rank(rank, k, device, job["trajectory"])["train"]}


def hang_on_rank(rank: int, k: int, device: torch.device, arg: int) -> int:
    """Every rank but ``arg`` waits in a barrier that rank ``arg`` never
    joins (it sleeps instead), as a group whose ranks built their subgroups
    in different orders would hang."""
    import time

    import torch.distributed as dist

    if rank == arg:
        time.sleep(120)
    else:
        dist.barrier()
    return rank


def hier_checks(rank: int, k: int, device: torch.device, job: dict) -> dict:
    """tests/test_torch_hier_halo.py's rank body, on 2 pods × 2 ranks.

    ``job``: ``plan`` (hierarchical), ``flat_plan`` (the same partition,
    flat), ``z`` (n_local, d) and ``ct`` (k_model·B, d) this rank's blocks
    of a test matrix and of a cotangent, ``z16`` a bf16-exact block for the
    flat int8 wire, and three `RankJob`s: ``hier`` (forwards and first
    gradients on the hierarchical plan), ``flat`` (the same forwards on the
    flat plan) and ``trajectory`` (a short training run, hierarchical).
    Returns the rank's groups, the hierarchical halo block and its
    pull-back per (lowering, wire format) with the rows each phase received,
    the flat int8 block of the bf16 table, and the jobs' reports."""
    import torch.distributed as dist

    from repro_torch.dist.halo import hier_halo_exchange
    from repro_torch.launch.distributed_gcn import halo_train_rank
    from repro_torch.launch.mesh import halo_groups
    from repro_torch.obs import metrics
    from repro_torch.train.elastic import MeshPlan

    plan = job["plan"]
    groups = halo_groups(plan.n_pods)
    mesh = MeshPlan(shape=(plan.n_pods, plan.k_model), axes=("data", "model")).build()
    out = {"groups": [dist.get_process_group_ranks(g) for g in groups],
           "mesh": {a: dist.get_process_group_ranks(g) for a, g in mesh.items()},
           "pods_1_is_flat": halo_groups(1) is None,
           "halo": {}, "dz": {}, "phase_rows": {}}
    send_loc, send_rem = plan.rank_arrays(rank, device)[:2]
    ct = torch.from_numpy(job["ct"]).to(device)
    for via in VIAS:
        for payload in PAYLOADS:
            z = torch.from_numpy(job["z"]).to(device).requires_grad_(True)
            registry = metrics.enable(metrics.MetricsRegistry())
            halo = hier_halo_exchange(z, send_loc, send_rem, groups, via=via, payload=payload)
            out["phase_rows"][via, payload] = {
                phase: int(registry.counter("halo.wire_rows", (("phase", phase),)).value)
                for phase in ("inter_pod", "intra_pod")}
            metrics.disable()
            out["halo"][via, payload] = halo.detach().numpy()
            out["dz"][via, payload] = torch.autograd.grad(halo, z, ct, retain_graph=payload is None)[0].numpy()
            if payload is None:
                out["dz_ones", via] = torch.autograd.grad(halo, z, torch.ones_like(halo))[0].numpy()
    from repro_torch.dist.halo import halo_aggregate, hier_halo_aggregate
    from repro_torch.obs.instrument import overlap_timeline
    from repro_torch.obs.trace import TraceRecorder

    z = torch.from_numpy(job["z"]).to(device)
    flat_arrays = job["flat_plan"].rank_arrays(rank, device)
    out["overlap"] = {
        "hier": (overlap_timeline(plan, z, groups, tracer=TraceRecorder(), steps=1).numpy(),
                 hier_halo_aggregate(z, *plan.rank_arrays(rank, device), groups).numpy()),
        "flat": (overlap_timeline(job["flat_plan"], z, None, tracer=TraceRecorder(), steps=1, payload="bf16").numpy(),
                 halo_aggregate(z, *flat_arrays, payload="bf16").numpy())}
    flat_send = flat_arrays[0]
    z16 = torch.from_numpy(job["z16"]).to(device, torch.bfloat16)
    flat16 = halo_exchange(z16, flat_send, payload="int8")
    out["flat_int8_bf16"] = (flat16.float().numpy(), str(flat16.dtype).removeprefix("torch."))
    out["hier"] = halo_rank(rank, k, device, job["hier"])
    out["flat"] = halo_rank(rank, k, device, job["flat"])
    out["trajectory"] = halo_train_rank(rank, k, device, job["trajectory"])["train"]
    return out


def delta_group(rank: int, k: int, device: torch.device, job) -> dict:
    """tests/test_torch_delta_group.py's rank body: `delta_rank` on a
    `DeltaJob` (flat and 2 × 2 plans over one planner replica), plus the
    rank's groups, so the test can see the hierarchical schedule ran on
    its own subgroups."""
    import torch.distributed as dist

    from repro_torch.launch.distributed_gcn import delta_rank
    from repro_torch.launch.mesh import halo_groups

    out = delta_rank(rank, k, device, job)
    out["pod_groups"] = [dist.get_process_group_ranks(g) for g in halo_groups(job.pods)]
    return out


def rank3_exchange(rank: int, k: int, device: torch.device, job: dict) -> dict:
    """tests/test_torch_equiformer.py's rank body: this rank's (n_local, K, C)
    block of ``job["tables"]`` through `halo_exchange` per (wire format,
    lowering) — the halo block, the rows and bytes its forward counted, and
    for fp32 and bf16 the pull-back of a ones cotangent with the bytes the
    backward counted — and through `hier_halo_exchange` on ``job["pods"]``
    pods (fp32): the block's shape, its bytes and its inter-pod rows."""
    from repro_torch.dist.halo import hier_halo_exchange
    from repro_torch.launch.mesh import halo_groups
    from repro_torch.obs import metrics

    send_idx = torch.from_numpy(job["send_idx"][rank]).to(device)
    out = {}
    for payload in PAYLOADS:
        for via in VIAS:
            h = torch.from_numpy(job["tables"][rank]).to(device).requires_grad_(True)
            registry = metrics.enable(metrics.MetricsRegistry())
            try:
                halo = halo_exchange(h, send_idx, via=via, payload=payload)
                rec = dict(halo=halo.detach().numpy(), wire_rows=registry.counter("halo.wire_rows").value,
                           wire_bytes=registry.counter("halo.wire_bytes").value)
                if payload != "int8":
                    rec["grad"] = torch.autograd.grad(halo, h, torch.ones_like(halo))[0].numpy()
                    rec["backward_wire_bytes"] = registry.counter("halo.wire_bytes").value - rec["wire_bytes"]
            finally:
                metrics.disable()
            out[payload, via] = rec
    groups = halo_groups(job["pods"])
    send_loc, send_rem = (torch.from_numpy(job[name][rank]).to(device) for name in ("send_loc", "send_rem"))
    registry = metrics.enable(metrics.MetricsRegistry())
    try:
        halo = hier_halo_exchange(torch.from_numpy(job["tables"][rank]).to(device), send_loc, send_rem, groups)
        out["hier"] = dict(shape=tuple(halo.shape), wire_bytes=registry.counter("halo.wire_bytes").value,
                           inter_pod_rows=registry.counter("halo.wire_rows", (("phase", "inter_pod"),)).value)
    finally:
        metrics.disable()
    return out
