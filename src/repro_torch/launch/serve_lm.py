"""Serving example — twin of `examples/serve_lm.py`: batched prefill and
KV-cache decode with the reduced gemma3-style sliding-window LM.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu

On one device (the CUDA card unless ``--device`` names another), with
parameters from a seeded `torch.Generator` and seeded prompts: fills the
KV cache by teacher-forced decode steps over the prompt, holds the last
step's logits against `lm_forward`'s at the last position (its attention
runs K4 on the card) and prints the largest difference, then decodes
greedily and prints the tokens per second and the first stream's tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.transformer_lm import lm_decode_step, lm_forward, lm_init, lm_init_cache

__all__ = ["main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> float:
    """Runs the example; returns the decode-vs-forward max error."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch("gemma3-12b").make_reduced()
    print(f"model: {cfg.name} ({cfg.n_layers}L, window={cfg.window}, "
          f"global every {cfg.global_every})")
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)

    batch, prompt_len, gen_len, max_len = 4, 24, 16, 64
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (batch, prompt_len))).to(device)

    with torch.inference_mode():
        # ---- prefill: fill the cache via decode steps (teacher-forced, so
        # decode == forward is also checked here).
        cache = lm_init_cache(cfg, batch, max_len, device=device)
        logits = None
        t0 = time.perf_counter()
        for t in range(prompt_len):
            logits, cache = lm_decode_step(params, cache, prompts[:, t], t, cfg)
        _sync(device)
        prefill_s = time.perf_counter() - t0
        ref, _ = lm_forward(params, prompts, cfg)
        err = float((logits - ref[:, -1]).abs().max())
        print(f"prefill {prompt_len} tokens in {prefill_s*1e3:.1f} ms; "
              f"decode-vs-forward max err {err:.2e}")

        # ---- greedy decode
        tok = logits.argmax(-1)
        out = [tok]
        t0 = time.perf_counter()
        for t in range(prompt_len, prompt_len + gen_len):
            logits, cache = lm_decode_step(params, cache, tok, t, cfg)
            tok = logits.argmax(-1)
            out.append(tok)
        _sync(device)
        dt = time.perf_counter() - t0
    gen = torch.stack(out, 1)
    print(f"generated {gen_len} tokens × {batch} streams in {dt*1e3:.1f} ms "
          f"({batch * gen_len / dt:.0f} tok/s on {device.type})")
    print("sample token ids:", gen[0, :10].tolist())
    return err


if __name__ == "__main__":
    main()
