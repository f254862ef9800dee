"""The rank body of tests/test_torch_halo.py's process group.

The spawned ranks import this module by name (the test directory is on
their path), so it imports neither JAX nor `repro`: only torch, numpy and
`repro_torch`. One call per rank runs the raw exchange checks and then the
sharded forwards of `repro_torch.launch.distributed_gcn.halo_rank`.
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
