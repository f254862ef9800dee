"""Serving entry point — twin of `repro.launch.serve` for the architectures the
port has reached: batched greedy decode for the dense LMs, batched scoring
for DeepFM.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --requests 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepfm --device cpu

Runs the REDUCED config on one device (the CUDA card unless ``--device``
names another), with parameters from a seeded `torch.Generator`. An LM
(gemma3-12b, stablelm-12b, granite-34b) decodes ``--tokens`` greedy tokens
for a batch of 4 streams through `lm_decode_step` from seeded first tokens
and prints the tokens per second. DeepFM scores one batch of 512 examples of
seeded ids: one warm-up forward, then ``--requests`` forwards, each ended by
a synchronisation, and prints the median request time and the rate; its FM
term runs K3 on the card. The MoE LMs and GCN node-query serving come with
later slices of the port and raise `NotImplementedError` naming them.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.registry import ALL_ARCHS, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.obsflags import add_obs_args, obs_session

__all__ = ["serve_lm", "serve_recsys", "main"]

# The slice of the port (ROADMAP.md) that brings serving for each architecture.
_WAITING = {
    **dict.fromkeys(("moonshot-v1-16b-a3b", "olmoe-1b-7b"), "the MoE slice (nn/moe.py)"),
    "coin_gcn": "the GraphBatcher serving slice (serve/graph.py, graph/sampler.py)",
    **dict.fromkeys(("egnn", "graphcast", "equiformer-v2", "pna"), "the slice of the other GNN families"),
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(spec, gen_tokens: int, device: torch.device, batch: int = 4) -> float:
    """Greedy-decode ``gen_tokens`` tokens for ``batch`` streams with the
    reduced LM through `lm_decode_step`; prints and returns the tokens per
    second (host clock, the last step ended by a synchronisation)."""
    from repro_torch.models.transformer_lm import lm_decode_step, lm_init, lm_init_cache

    cfg = spec.make_reduced()
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    cache = lm_init_cache(cfg, batch, gen_tokens + 8, device=device)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, batch)).to(device)
    with torch.inference_mode():
        t0 = time.perf_counter()
        for t in range(gen_tokens):
            logits, cache = lm_decode_step(params, cache, tok, t, cfg)
            tok = logits.argmax(-1)
        _sync(device)
        dt = time.perf_counter() - t0
    print(f"{spec.arch_id}: {batch}×{gen_tokens} tokens in {dt*1e3:.1f} ms "
          f"({batch*gen_tokens/dt:.0f} tok/s)")
    return batch * gen_tokens / dt


def serve_recsys(spec, requests: int, device: torch.device, batch: int = 512) -> float:
    """Score ``requests`` batches of ``batch`` examples with the reduced
    DeepFM; prints and returns the median request time in ms."""
    from repro_torch.models.deepfm import deepfm_forward, deepfm_init

    cfg = spec.make_reduced()
    params = deepfm_init(torch.Generator().manual_seed(0), cfg, device=device)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.rows_per_field, (batch, cfg.n_fields))).to(device, torch.int64)
    times = []
    with torch.inference_mode():
        deepfm_forward(params, ids, cfg)
        _sync(device)
        for _ in range(requests):
            t0 = time.perf_counter()
            deepfm_forward(params, ids, cfg)
            _sync(device)
            times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"deepfm: batch={batch} p50≈{dt*1e3:.2f} ms ({batch/dt:.0f} examples/s)")
    return dt * 1e3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help=f"one of {', '.join(ALL_ARCHS)} (hyphen/underscore both fine)")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    with obs_session(args):
        run(args)


def run(args) -> None:
    arch = args.arch.replace("-", "_") if args.arch.replace("-", "_") in ALL_ARCHS else args.arch
    if arch in _WAITING:
        raise NotImplementedError(
            f"serving --arch {args.arch} is not ported to PyTorch yet; it comes with {_WAITING[arch]} "
            "(ROADMAP.md)")
    spec = get_arch(arch)
    if spec.family == "lm":
        if args.tokens < 1:
            raise SystemExit("--tokens must be at least 1")
        serve_lm(spec, args.tokens, resolve_device(args.device))
        return
    if args.requests < 1:
        raise SystemExit("--requests must be at least 1")
    serve_recsys(spec, args.requests, resolve_device(args.device))


if __name__ == "__main__":
    main()
