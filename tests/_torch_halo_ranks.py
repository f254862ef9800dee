"""The rank bodies of the process groups of tests/test_torch_halo.py and
tests/test_torch_halo_train.py.

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
    `compressed_psum_mean` of ``job["psum_mean"]``, the first gradient of every training variant (``job["grads"]``, a
    `RankJob` with no steps), a short training run that checkpoints
    (``job["trajectory"]``), then the same job again, which resumes."""
    from repro_torch.launch.distributed_gcn import halo_train_rank

    from repro_torch.train.compression import compressed_psum_mean

    return {"exchange": exchange_grads(rank, device, job["exchange"]),
            "psum_mean": compressed_psum_mean(torch.from_numpy(job["psum_mean"]).to(device)).cpu().numpy(),
            "grads": halo_train_rank(rank, k, device, job["grads"])["train"],
            "trajectory": halo_train_rank(rank, k, device, job["trajectory"])["train"],
            "resumed": halo_train_rank(rank, k, device, job["trajectory"])["train"]}
