"""Mixture-of-Experts FFN with sort-based capacity dispatch — twin of
`repro.nn.moe`.

Top-k routing → stable sort by expert id → position-in-expert via exclusive
cumsum of expert counts → scatter into an (E, C, D) buffer → batched expert
GEMMs → gather + gate-weighted combine. All shapes static (capacity factor),
no (T, E, C) one-hot tensors.

The reference's algorithm step by step, so that capacity drops the same
(token, expert) pairs:

* top-k over the fp32 softmax with the lower expert index first among equal
  probabilities (``jax.lax.top_k``'s order; `torch.topk` does not specify
  one, so the port takes the first k of a stable descending sort), the
  gates renormalised;
* a stable sort of the flat (T·K) assignments by expert id, in the order
  the reference builds with ``tile(arange(T))``;
* the position in the expert from the exclusive cumsum of the counts,
  ``keep = pos < C``, and a scatter-add into (G, E, C, D) that adds a zero
  row where ``keep`` is false (at ``pos_c = C − 1``, as the reference does);
* the SwiGLU expert GEMMs as `torch.einsum` (plain large products: the
  reference computes them outside any Pallas kernel);
* gather, then a gate-weighted `index_add_` back to the tokens;
* the Switch load-balance loss ``E·Σ_e f_e·p_e``.

``groups = G > 1`` (the reference's ``vmap`` over token groups) is a reshape
to (G, T/G, ·) with every step of the dispatch batched over the leading
axis. The only policy taken is ``None`` / `NO_POLICY`: the expert-parallel
layout is a later slice (ROADMAP.md queue 1 item 6).

``RECORD``, when set to a list, receives one dict per `moe_apply` call:
``dropped`` (the (token, expert) pairs that capacity dropped) and ``aux``
(the call's load-balance loss), both as detached 0-dim tensors on the
input's device, so recording adds no host synchronisation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY
from repro_torch.nn.layers import normal, silu

__all__ = ["MoEConfig", "moe_init", "moe_apply", "RECORD"]

RECORD: list | None = None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    # Hierarchical dispatch: sort/bucket tokens WITHIN each of `groups`
    # token groups (one per data shard). groups=1 is the flat dispatch.
    groups: int = 1

    def capacity(self, n_tokens: int) -> int:
        cap = int(self.capacity_factor * n_tokens * self.top_k / self.num_experts)
        cap = max(8, -(-cap // 8) * 8)  # round up to 8 for tiling
        # Streams of ≤ 512 tokens dispatch drop-free: a token takes at most
        # one slot per expert, so C ≥ T can never overflow, and stepwise
        # decode equals the full forward pass. Above it capacity may drop
        # tokens under routing imbalance.
        if n_tokens <= 512:
            cap = max(cap, -(-n_tokens // 8) * 8)
        return cap


def moe_init(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32,
             device: str | torch.device | None = None, n_layers: int | None = None) -> dict:
    """The reference's leaves and scales; with ``n_layers`` each leaf has a
    leading layer axis (the LM's stacked tree), drawn in one piece."""
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    std_in, std_out = (1.0 / D) ** 0.5, (1.0 / F) ** 0.5
    lead = () if n_layers is None else (n_layers,)

    def draw(shape, std):
        return normal(generator, lead + shape, dtype, device).mul_(std)

    return {
        "router": draw((D, E), std_in),
        "w_gate": draw((E, D, F), std_in),
        "w_up": draw((E, D, F), std_in),
        "w_down": draw((E, F, D), std_out),
    }


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, gate_vals, expert_idx, E: int, K: int, C: int):
    """Sort-based dispatch of G token groups at once: x (G, T, D), gates and
    expert ids (G, T, K) → ((G, E, C, D) buffer, meta)."""
    G, T, D = x.shape
    device = x.device
    flat_e = expert_idx.reshape(G, T * K)
    flat_t = torch.arange(T, device=device).repeat_interleave(K).expand(G, T * K)
    flat_g = gate_vals.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se, st, sg = flat_e.gather(1, order), flat_t.gather(1, order), flat_g.gather(1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=device).scatter_add_(1, se, torch.ones_like(se))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(T * K, device=device) - starts.gather(1, se)
    keep = pos < C
    pos_c = pos.clamp(max=C - 1)
    gi = torch.arange(G, device=device)[:, None].expand(G, T * K)
    rows = torch.where(keep[..., None], x[gi, st], torch.zeros((), dtype=x.dtype, device=device))
    buf = torch.zeros((G, E, C, D), dtype=x.dtype, device=device).index_put((gi, se, pos_c), rows, accumulate=True)
    return buf, (gi, se, st, sg, keep, pos_c)


def _combine(y, meta, T: int, D: int):
    """Gather each kept assignment's expert output, weight it by its gate and
    add it back to its token: (G, E, C, D) → (G, T, D)."""
    gi, se, st, sg, keep, pos_c = meta
    G = y.shape[0]
    w = torch.where(keep, sg, torch.zeros((), dtype=sg.dtype, device=sg.device)).to(y.dtype)
    tok_y = y[gi, se, pos_c] * w[..., None]
    out = torch.zeros((G * T, D), dtype=y.dtype, device=y.device)
    return out.index_add(0, (gi * T + st).reshape(-1), tok_y.reshape(-1, D)).reshape(G, T, D)


def _check_policy(policy) -> None:
    if policy is not None and policy is not NO_POLICY:
        raise NotImplementedError("moe_apply takes only policy=None or NO_POLICY in the port: the expert-parallel "
                                  "layout comes with the sharded LM (ROADMAP.md queue 1 item 6)")


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, policy=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens → (out: (T, D), aux_loss: fp32 scalar).

    aux_loss is the Switch/GShard load-balance loss E·Σ_e f_e·p_e over all T
    tokens. With cfg.groups = G > 1 routing's sort and scatter run per group
    of T/G tokens, each group with capacity ``cfg.capacity(T // G)``."""
    _check_policy(policy)
    T, D = x.shape
    E, K, G = cfg.num_experts, cfg.top_k, cfg.groups
    assert T % G == 0, (T, G)
    logits = x @ p["router"]                              # (T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)              # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance auxiliary loss (global statistics)
    frac_tokens = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1), torch.ones(T * K, dtype=torch.float32, device=x.device)) / (T * K)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)

    C = cfg.capacity(T // G)
    buf, meta = _dispatch(x.reshape(G, T // G, D), gate_vals.reshape(G, T // G, K),
                          expert_idx.reshape(G, T // G, K), E, K, C)

    # ---- expert GEMMs (SwiGLU), E-major as the reference's
    h = silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"])    # (G, E, C, D)

    out = _combine(y, meta, T // G, D)
    if RECORD is not None:
        RECORD.append({"dropped": (~meta[4]).sum().detach(), "aux": aux.detach()})
    return out.reshape(T, D), aux
