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
axis.

Under a grid policy (`repro_torch.launch.shardings.lm_policy`, bound to
the rank) the layer is expert parallel: rank m of the model group holds
experts [m·E/k, (m+1)·E/k) of ``w_gate``/``w_up``/``w_down`` (the
reference's spec ``P(None, "model", None, None)``), the router whole. The
tokens are the same on every rank of the model group, so each rank routes
all of its data shard's tokens as the reference does, runs its own
experts on its slice of the (G, E, C, D) buffer, combines only their
contributions and sums the result over the model group (the reference's
all-to-all is XLA's lowering of the same function). Over the data group
the function stays the reference's over the global batch: the expert ids
(integers, no gradient) are gathered, so that every rank computes the
global positions in each expert and therefore the reference's capacity
drops; a rank then dispatches and combines only its own tokens. The aux
loss takes its token fractions from the gathered ids and its mean
probabilities from a `psum` over the data group. The router's input and
the gates enter the per-rank dispatch and combine through `replicate`, so
their gradients are summed over the model group.

``RECORD``, when set to a list, receives one dict per `moe_apply` call:
``dropped`` (the (token, expert) pairs that capacity dropped), ``aux``
(the call's load-balance loss) and ``margin`` (the smallest gap between a
token's k-th and (k+1)-th routing probability: how near routing came to
a tie), as detached 0-dim tensors, and ``experts`` (the (T, K) expert ids
of every token, of the global batch under a data size above 1), all on
the input's device, so recording adds no host synchronisation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY
from repro_torch.nn.layers import Draw, init_tree, silu

__all__ = ["MoEConfig", "moe_param_plan", "moe_init", "moe_apply", "RECORD"]

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


def moe_param_plan(cfg: MoEConfig, n_layers: int | None = None) -> dict:
    """The reference's leaves and scales; with ``n_layers`` each leaf has a
    leading layer axis (the LM's stacked tree). A seeded draw takes them per
    layer and the experts' leaves per expert."""
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    std_in, std_out = (1.0 / D) ** 0.5, (1.0 / F) ** 0.5
    lead = () if n_layers is None else (n_layers,)

    def leaf(shape, std, units):
        return Draw(lead + shape, std=std, units=lead + units)

    return {
        "router": leaf((D, E), std_in, (1, 1)),
        "w_gate": leaf((E, D, F), std_in, (E, 1, 1)),
        "w_up": leaf((E, D, F), std_in, (E, 1, 1)),
        "w_down": leaf((E, F, D), std_out, (E, 1, 1)),
    }


def moe_init(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32,
             device: str | torch.device | None = None, n_layers: int | None = None) -> dict:
    """`moe_param_plan` drawn from ``generator``, each leaf in one piece."""
    return init_tree(generator, moe_param_plan(cfg, n_layers), dtype, device)


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x, gate_vals, expert_idx, E: int, K: int, C: int, own=None, e_lo: int = 0, e_n: int | None = None):
    """Sort-based dispatch of G token groups at once: x (G, T, D), gates and
    expert ids (G, T, K) → ((G, e_n, C, D) buffer of experts [e_lo, e_lo +
    e_n), meta). Positions in each expert count every token; only tokens
    where ``own`` (G, T) is true are written (all by default)."""
    G, T, D = x.shape
    e_n = E if e_n is None else e_n
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
    write = keep & (se >= e_lo) & (se < e_lo + e_n)
    if own is not None:
        write = write & own.gather(1, st)
    le = (se - e_lo).clamp(0, e_n - 1)
    rows = torch.where(write[..., None], x[gi, st], torch.zeros((), dtype=x.dtype, device=device))
    buf = torch.zeros((G, e_n, C, D), dtype=x.dtype, device=device).index_put((gi, le, pos_c), rows, accumulate=True)
    return buf, (gi, le, st, sg, write, keep, pos_c)


def _combine(y, meta, T: int, D: int):
    """Gather each written assignment's expert output, weight it by its gate
    and add it back to its token: (G, e_n, C, D) → (G, T, D)."""
    gi, le, st, sg, write, _, pos_c = meta
    G = y.shape[0]
    w = torch.where(write, sg, torch.zeros((), dtype=sg.dtype, device=sg.device)).to(y.dtype)
    tok_y = y[gi, le, pos_c] * w[..., None]
    out = torch.zeros((G * T, D), dtype=y.dtype, device=y.device)
    return out.index_add(0, (gi * T + st).reshape(-1), tok_y.reshape(-1, D)).reshape(G, T, D)


def _check_policy(policy) -> None:
    if policy is not None and policy.comm == "halo":
        raise NotImplementedError("moe_apply takes None, NO_POLICY or a grid policy (launch.shardings.lm_policy); "
                                  "a halo policy is the GCN's")


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, policy=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens → (out: (T, D), aux_loss: fp32 scalar).

    aux_loss is the Switch/GShard load-balance loss E·Σ_e f_e·p_e over all
    tokens (of the global batch, under a data size above 1). With
    cfg.groups = G > 1 routing's sort and scatter run per group of T/G
    tokens, each group with capacity ``cfg.capacity(T // G)`` (T global)."""
    _check_policy(policy)
    policy = policy or NO_POLICY
    T, D = x.shape
    E, K, G = cfg.num_experts, cfg.top_k, cfg.groups
    n_data, d = policy.n_data, policy.data_index
    if E % policy.n_model:
        raise NotImplementedError(f"{E} experts do not split over a model size of {policy.n_model}")
    e_n = E // policy.n_model
    e_lo = policy.model_index * e_n
    T_all = T * n_data
    assert T_all % G == 0, (T_all, G)
    logits = x @ p["router"]                              # (T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = _top_k(probs, K)              # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    all_idx = policy.data_gather(expert_idx)              # (T_all, K): the global routing, no gradient

    # ---- load-balance auxiliary loss (global statistics)
    frac_tokens = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, all_idx.reshape(-1), torch.ones(T_all * K, dtype=torch.float32, device=x.device)) / (T_all * K)
    frac_probs = probs.mean(dim=0) if n_data == 1 else policy.data_psum(probs.sum(dim=0)) / T_all
    aux = E * torch.sum(frac_tokens * frac_probs)

    # ---- the groups that hold this rank's tokens, at the global positions
    Tg = T_all // G
    g_lo, g_hi = d * T // Tg, ((d + 1) * T - 1) // Tg + 1
    C = cfg.capacity(Tg)
    x_in = policy.model_replicate(x)
    gates = policy.model_replicate(gate_vals)
    span, off = (g_hi - g_lo) * Tg, d * T - g_lo * Tg
    if span == T:
        xs, gs, own = x_in, gates, None
    else:
        pad = lambda t: torch.cat([t.new_zeros((off, *t.shape[1:])), t, t.new_zeros((span - off - T, *t.shape[1:]))])
        xs, gs = pad(x_in), pad(gates)
        own = torch.zeros(span, dtype=torch.bool, device=x.device)
        own[off:off + T] = True
        own = own.reshape(g_hi - g_lo, Tg)
    ids = all_idx[g_lo * Tg:g_hi * Tg]
    buf, meta = _dispatch(xs.reshape(-1, Tg, D), gs.reshape(-1, Tg, K), ids.reshape(-1, Tg, K), E, K, C,
                          own=own, e_lo=e_lo, e_n=e_n)

    # ---- expert GEMMs (SwiGLU), E-major as the reference's
    h = silu(torch.einsum("gecd,edf->gecf", buf, p["w_gate"])) * torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    y = torch.einsum("gecf,efd->gecd", h, p["w_down"])    # (G, e_n, C, D)

    out = _combine(y, meta, Tg, D).reshape(span, D)[off:off + T]
    out = policy.model_psum(out)
    if RECORD is not None:
        dropped = ~meta[5] if own is None else ~meta[5] & own.gather(1, meta[2])
        dropped = policy.data_psum(dropped.sum().float()).long() if n_data > 1 else dropped.sum()
        ranked = torch.sort(probs.detach(), dim=-1, descending=True).values
        margin = (ranked[:, K - 1] - ranked[:, K]).min() if K < E else torch.tensor(float("inf"))
        RECORD.append({"dropped": dropped.detach(), "aux": aux.detach(), "margin": margin, "experts": all_idx})
    return out, aux
