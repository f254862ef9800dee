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

The cache lives on the parameters' device. `ContinuousBatcher` is
unsharded, as the reference's is; `decode_multi_pos` also takes the
reference's ``policy``. Where the reference blends the
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


def decode_multi_pos(params, cache, tokens, positions, cfg, policy=None):
    """One decode step with PER-SLOT positions (continuous batching).

    tokens: (B,) int; positions: (B,) int. The same layer math as
    `lm_decode_step` (`repro_torch.models.transformer_lm.decode_layers`),
    with the cache write and the mask indexed per slot. Under a grid policy
    (the reference's ``policy`` argument) each rank holds its block of the
    cache, as the policy's cache spec says, and the logits are its vocab
    shard. Returns (logits (B, V) fp32, the cache updated in place)."""
    from repro_torch.dist.policy import NO_POLICY
    from repro_torch.models.transformer_lm import decode_layers

    device = params["embed"].device
    logits = decode_layers(params, cache, tokens.to(device), positions.to(device).long(), cfg, policy or NO_POLICY)
    return logits, cache


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
