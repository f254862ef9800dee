"""Training loop with fault tolerance and straggler monitoring — twin of
`repro.train.loop`, as an eager step.

Features (DESIGN.md §3):
  * a train step (loss + grads + optimizer update) with optional gradient
    accumulation over a leading microbatch axis of the batch,
  * optional gradient compression with error feedback (train/compression.py),
  * step-level checkpointing (atomic; train/checkpoint.py) and restart —
    `Trainer.fit` resumes from the latest complete checkpoint after a crash,
  * straggler monitoring: per-step wall time vs an EMA; steps slower than
    `straggler_factor ×` EMA are logged as events.

The reference jits the step and donates its buffers. Here the step runs
eagerly: each step takes fresh leaf copies of the parameters that require a
gradient, `torch.autograd.grad` returns the gradients (so nothing
accumulates in ``.grad``), and the update runs under `torch.no_grad`. The
loss is read back with ``float(loss)`` after every step, which waits for
the card, so each step's wall time covers its device work.

Inside a `torch.distributed` group (sharded training: one `Trainer` per
rank, each stepping identical parameters on its own loss, which the
sharded loss makes identical) the reference's single controller writes one
checkpoint: here global rank 0 writes it and every rank waits for it at a
barrier; every rank resumes from it. The straggler monitor is per rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.train.compression import error_feedback_update, int8_compress, int8_decompress
from repro_torch.train.optimizer import Optimizer
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["TrainerConfig", "Trainer", "value_and_grad"]


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    grad_accum: int = 1
    compress_grads: bool = False
    straggler_factor: float = 3.0
    ema_decay: float = 0.9


def value_and_grad(loss_fn: Callable, params: Any, batch: Any) -> tuple[torch.Tensor, Any]:
    """``(loss, d loss / d params)`` of ``loss_fn(params, batch)``, the
    gradients as a tree shaped like ``params`` (zeros where a parameter does
    not reach the loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _int8_channel(g: torch.Tensor) -> torch.Tensor:
    q, s = int8_compress(g)
    return int8_decompress(q, s, g.dtype)


class Trainer:
    def __init__(
        self,
        loss_fn: Callable,              # (params, batch) -> scalar loss
        optimizer: Optimizer,
        params: Any,
        cfg: TrainerConfig | None = None,
    ):
        self.cfg = cfg = cfg if cfg is not None else TrainerConfig()
        self.opt = optimizer
        self.params = tree_map(lambda p: p.detach(), params)
        self.opt_state = optimizer.init(self.params)
        self.residual = tree_map(torch.zeros_like, self.params) if cfg.compress_grads else None
        self.step = 0
        self.straggler_events: list[dict] = []
        self._ema_dt: float | None = None
        self._loss_fn = loss_fn
        self._step_fn = self._train_step

    # -------------------------------------------------------------- the step
    def _grads(self, params, batch):
        cfg = self.cfg
        if cfg.grad_accum == 1:
            return value_and_grad(self._loss_fn, params, batch)
        # batch leaves have a leading microbatch axis of size grad_accum.
        loss, acc = 0.0, None
        for i in range(cfg.grad_accum):
            mb = tree_map(lambda x: x[i], batch)
            l, g = value_and_grad(self._loss_fn, params, mb)
            loss = loss + l
            acc = g if acc is None else tree_map(torch.add, acc, g)
        scale = 1.0 / cfg.grad_accum
        return loss * scale, tree_map(lambda g: g * scale, acc)

    def _train_step(self, params, opt_state, residual, batch):
        loss, grads = self._grads(params, batch)
        with torch.no_grad():
            if self.cfg.compress_grads:
                grads, residual = error_feedback_update(grads, residual, _int8_channel)
            new_params, new_opt = self.opt.update(grads, opt_state, params)
        return new_params, new_opt, residual, loss

    # ---------------------------------------------------------------- resume
    def resume(self) -> bool:
        """Restore the latest checkpoint if one exists. Returns True if so."""
        if not self.cfg.ckpt_dir:
            return False
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        self.step, restored, _meta = restore_checkpoint(self.cfg.ckpt_dir, state, step=last)
        self.params, self.opt_state = restored["params"], restored["opt"]
        return True

    def checkpoint(self) -> None:
        """Write this step's checkpoint: in a process group only rank 0
        writes, and every rank returns once it exists."""
        if not self.cfg.ckpt_dir:
            return
        grouped = dist.is_available() and dist.is_initialized()
        if not grouped or dist.get_rank() == 0:
            save_checkpoint(
                self.cfg.ckpt_dir,
                self.step,
                {"params": self.params, "opt": self.opt_state},
                metadata={"time": time.time()},
            )
        if grouped:
            dist.barrier()

    # ------------------------------------------------------------------- fit
    def fit(
        self,
        batches: Iterator[Any],
        max_steps: int,
        crash_at: int | None = None,     # fault-injection hook for tests
        log: Callable[[str], None] = print,
    ) -> list[float]:
        losses = []
        for batch in batches:
            if self.step >= max_steps:
                break
            t0 = time.perf_counter()
            with _obs_trace.span("train.step", args={"step": self.step}):
                self.params, self.opt_state, self.residual, loss = self._step_fn(
                    self.params, self.opt_state, self.residual, batch
                )
                loss = float(loss)      # waits for the card: the span covers device work
            dt = time.perf_counter() - t0
            self.step += 1
            losses.append(loss)
            if _obs_metrics.enabled():
                _obs_metrics.inc("train.steps")
                _obs_metrics.observe("train.step_ms", dt * 1e3)
                _obs_metrics.set_gauge("train.loss", loss)
            # ---- straggler monitor
            if self._ema_dt is not None and dt > self.cfg.straggler_factor * self._ema_dt:
                self.straggler_events.append({"step": self.step, "dt": dt, "ema": self._ema_dt})
            self._ema_dt = dt if self._ema_dt is None else (
                self.cfg.ema_decay * self._ema_dt + (1 - self.cfg.ema_decay) * dt
            )
            if self.step % self.cfg.log_every == 0:
                log(f"step {self.step}: loss={loss:.4f} dt={dt*1e3:.1f}ms")
            if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                self.checkpoint()
            if crash_at is not None and self.step == crash_at:
                raise RuntimeError(f"injected crash at step {self.step}")
        return losses
