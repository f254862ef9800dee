"""Continuous batching for KV-cache decode (the serving-loop substrate) —
twin of `repro.serve.scheduler`.

The decode step runs for a FIXED batch of cache slots; requests
arrive/finish asynchronously. The scheduler owns the slot table:

  * admit: place a pending request in a free slot (its prompt tokens are
    teacher-forced through the same decode step — slot-local prefill, so one
    step function serves both phases),
  * step : one decode step for all active slots (idle slots run a no-op
    step at their stale position; their cache rows are rewritten before a
    new request reads them),
  * retire: slots whose request hit max_tokens (or emitted EOS) free up.

The slot-position vector is per slot, so the batcher drives
`decode_multi_pos`, the per-slot variant of `lm_decode_step`.

The cache lives on the parameters' device. Where the reference blends the
new key and value into the cache with a one-hot mask (``ck·(1 − onehot) +
onehot·k``, rewriting the whole cache in every layer of every step), the
port writes each slot's row at its position in place: on a finite cache the
two give the same values, and the in-place write moves one row per slot.
The step runs eagerly under `torch.inference_mode` (the reference jits it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

__all__ = ["Request", "ContinuousBatcher", "decode_multi_pos"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int
    eos_id: int | None = None
    # runtime state
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def decode_multi_pos(params, cache, tokens, positions, cfg):
    """One decode step with PER-SLOT positions (continuous batching).

    tokens: (B,) int; positions: (B,) int. Built on the same layer math as
    `lm_decode_step`, with the cache write and the mask indexed per slot.
    Returns (logits (B, V) fp32, the cache updated in place)."""
    from repro_torch.models.transformer_lm import _ffn, _head, _layer
    from repro_torch.nn.attention import NEG_INF, rope
    from repro_torch.nn.layers import rms_norm

    B = tokens.shape[0]
    acfg = cfg.attn
    hd, Hk, G = acfg.head_dim, cfg.n_kv_heads, acfg.q_groups
    Smax = cache["k"].shape[2]
    device = params["embed"].device
    tokens, positions = tokens.to(device).long(), positions.to(device).long()
    rows = torch.arange(B, device=device)
    k_pos = torch.arange(Smax, device=device)[None, :]
    masked = torch.tensor(NEG_INF, device=device)
    x = params["embed"][tokens][:, None, :] * (cfg.d_model ** 0.5)
    for i, win in enumerate(cfg.window_sizes()):
        lp = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["ln1"])
        q = rope((h @ lp["attn"]["wq"]).reshape(B, 1, cfg.n_heads, hd), positions[:, None], acfg.rope_theta)
        k = rope((h @ lp["attn"]["wk"]).reshape(B, 1, Hk, hd), positions[:, None], acfg.rope_theta)
        v = (h @ lp["attn"]["wv"]).reshape(B, 1, Hk, hd)
        ck[rows, positions] = k[:, 0]          # each slot's row at its own position
        cv[rows, positions] = v[:, 0]
        qg = q.reshape(B, Hk, G, hd) * (hd ** -0.5)
        s = torch.einsum("bhgd,bshd->bhgs", qg, ck).float()
        valid = (k_pos <= positions[:, None]) & (k_pos > positions[:, None] - int(win))
        s = torch.where(valid[:, None, None, :], s, masked)
        w = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhgs,bshd->bhgd", w.to(cv.dtype), cv).reshape(B, 1, cfg.n_heads * hd)
        x = x + attn @ lp["attn"]["wo"]
        f, _ = _ffn(lp, rms_norm(x, lp["ln2"]), cfg)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return (x[:, 0] @ _head(params, cfg)).float(), cache


class ContinuousBatcher:
    def __init__(self, params, cfg, n_slots: int, max_len: int,
                 sampler: Callable[[np.ndarray], np.ndarray] | None = None):
        from repro_torch.models.transformer_lm import lm_init_cache

        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        self.cache = lm_init_cache(cfg, n_slots, max_len, dtype=params["embed"].dtype, device=params["embed"].device)
        self.positions = np.zeros(n_slots, np.int32)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self.next_token = np.zeros(n_slots, np.int32)
        self._prefill_left: list[int] = [0] * n_slots
        self.sampler = sampler or (lambda logits: np.argmax(logits, axis=-1))
        self.steps_run = 0

    # --------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        assert len(req.prompt) + req.max_new_tokens <= self.max_len
        self.pending.append(req)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.pending:
                req = self.pending.pop(0)
                self.slot_req[slot] = req
                self.positions[slot] = 0
                self.next_token[slot] = req.prompt[0]
                self._prefill_left[slot] = len(req.prompt) - 1

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def step(self) -> None:
        """One engine iteration: admit → decode all slots → sample/retire →
        re-admit (a slot retired this step is refilled before the step ends,
        so the next decode runs at full occupancy)."""
        self._admit()
        if self.active == 0:
            return
        with torch.inference_mode():
            logits, self.cache = decode_multi_pos(
                self.params, self.cache,
                torch.from_numpy(self.next_token), torch.from_numpy(self.positions), self.cfg,
            )
            logits = logits.cpu().numpy()
        self.steps_run += 1
        sampled = self.sampler(logits)
        retired = False
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            pos = int(self.positions[slot])
            if self._prefill_left[slot] > 0:
                # teacher-forced prefill: feed the next prompt token
                idx = len(req.prompt) - self._prefill_left[slot]
                self.next_token[slot] = req.prompt[idx]
                self._prefill_left[slot] -= 1
            else:
                tok = int(sampled[slot])
                req.generated.append(tok)
                self.next_token[slot] = tok
                # Retire on budget, EOS (including one emitted on the very
                # first decode step), or cache exhaustion: the next decode
                # would write position pos+1, and pos+1 == max_len−1 is still
                # a legal row, so the bound is `pos + 2 > max_len`.
                if (
                    len(req.generated) >= req.max_new_tokens
                    or (req.eos_id is not None and tok == req.eos_id)
                    or pos + 2 > self.max_len
                ):
                    req.done = True
                    self.finished.append(req)
                    self.slot_req[slot] = None
                    retired = True
                    continue
            self.positions[slot] = pos + 1
        if retired and self.pending:
            self._admit()

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        for _ in range(max_steps):
            if not self.pending and self.active == 0:
                break
            self.step()
        return self.finished
