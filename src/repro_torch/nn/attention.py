"""GQA attention: RoPE, causal / sliding-window masks, the prefill path and
a KV-cache decode path — twin of `repro.nn.attention`.

One change of route, and no change of function: the reference's prefill
runs `_chunked_attention`, an online softmax over key chunks in jnp; here
`attention_apply` runs `repro_torch.kernels.ops.flash_attention` on
(B·H, S, Dh), which computes the same function — its plain version on CPU
tensors, the CUDA kernel K4 (`repro_torch.kernels.flash_attention`) on CUDA
tensors. The per-layer window is a runtime int, as the reference's traced
window is, so local and global layers share one kernel. The kernel's scale
is applied to the scores after the dot, where `_chunked_attention` applies
it to q first; the two round differently, within the reference suite's
3e-5 (`tests/test_kernels.py::test_flash_matches_model_attention`).

The gradient: the reference differentiates `_chunked_attention`; here
`ops.flash_attention` is an autograd function whose backward is
`repro_torch.kernels.flash_attention.flash_attention_vjp` (torch ops, the
same on both devices; K4 has no backward kernel, as the reference's has
none). ``attention_apply(..., kernel=flash_attention_plain)`` is ordinary
autograd through the plain version, the yardstick of the card's check.

The decode path (`attention_decode`) is the reference's plain einsum and
softmax over the cache, with no kernel, as there. It writes this step's key
and value into the cache in place (the reference returns an updated copy)
and returns the same tensors. It takes one position for every row, or one
per row (the continuous batcher's slots).

Under a grid policy (`repro_torch.launch.shardings.lm_policy`, bound to
the rank) both paths are Megatron's tensor-parallel attention over the
model group: ``wq`` column-parallel (the rank's H/k query heads), ``wk`` /
``wv`` column-parallel when the kv heads divide by k, else replicated
(each rank takes the kv heads its query heads read, and `replicate` sums
their gradient over the model group), ``wo`` row-parallel followed by
`psum`. K4 runs on each rank's (B·H/k, S, Dh). The decode path splits
the cache as the policy's ``cache`` spec says: by kv heads (each rank
attends its own heads), or by sequence: each rank holds every kv head for
a slice of the positions, the rank that owns a row's position writes its
key and value, every rank scores all query heads (gathered over the model
group) against its slice with global positions in the window mask, and
the ranks combine their (max, Σexp, Σexp·v) with all-reduces — a slice
with no valid key contributes (−inf, 0, 0).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.kernels import ops
from repro_torch.nn.layers import normal

__all__ = [
    "AttentionConfig",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "rope",
    "local_heads",
]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int | None = None
    rope_theta: float = 10_000.0
    kv_chunk: int = 1024            # the reference's online-softmax chunk; K4 picks its own tiles

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        assert self.n_heads % self.n_kv_heads == 0
        return self.n_heads // self.n_kv_heads


def attention_init(generator: torch.Generator, cfg: AttentionConfig, dtype=torch.float32,
                   device: str | torch.device | None = None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    std = (1.0 / d) ** 0.5
    return {
        "wq": normal(generator, (d, cfg.n_heads * hd), dtype, device).mul_(std),
        "wk": normal(generator, (d, cfg.n_kv_heads * hd), dtype, device).mul_(std),
        "wv": normal(generator, (d, cfg.n_kv_heads * hd), dtype, device).mul_(std),
        "wo": normal(generator, (cfg.n_heads * hd, d), dtype, device).mul_(std),
    }


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def local_heads(cfg: AttentionConfig, policy: ShardingPolicy = NO_POLICY) -> tuple[int, int, int, bool]:
    """(the rank's query heads, the first and one past the last kv head they
    read, whether ``wk``/``wv`` hold only this rank's kv heads). Query head
    h reads kv head h // G; the rank's query heads are the m-th of k equal
    runs."""
    k, m = policy.n_model, policy.model_index
    H, Hk, G = cfg.n_heads, cfg.n_kv_heads, cfg.q_groups
    if H % k:
        raise NotImplementedError(f"{H} query heads do not split over a model size of {k}")
    h_loc = H // k
    if Hk % k == 0:
        return h_loc, m * (Hk // k), (m + 1) * (Hk // k), True
    if h_loc % G and G % h_loc:
        raise NotImplementedError(f"{h_loc} query heads a rank straddle the kv groups of {G}")
    lo = m * h_loc // G
    return h_loc, lo, (m * h_loc + h_loc - 1) // G + 1, False


def _qkv(p: dict, x: torch.Tensor, cfg: AttentionConfig, positions: torch.Tensor,
         policy: ShardingPolicy = NO_POLICY, every_kv: bool = False):
    """q of the rank's query heads; k, v of the kv heads they read (of
    every kv head the rank's ``wk`` holds, with ``every_kv``)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h_loc, lo, hi, kv_sharded = local_heads(cfg, policy)
    x = policy.model_replicate(x)
    wk, wv = p["wk"], p["wv"]
    if not kv_sharded:
        wk, wv = policy.model_replicate(wk), policy.model_replicate(wv)
    q = (x @ p["wq"]).reshape(B, S, h_loc, hd)
    k = (x @ wk).reshape(B, S, -1, hd)
    v = (x @ wv).reshape(B, S, -1, hd)
    if not kv_sharded and not every_kv and (lo, hi) != (0, cfg.n_kv_heads):
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(
    p: dict,
    x: torch.Tensor,
    cfg: AttentionConfig,
    window: int | None = None,
    positions: torch.Tensor | None = None,
    kernel=None,
    policy: ShardingPolicy = NO_POLICY,
) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention for the training
    forward and prefill.

    ``kernel`` computes the attention of (B·H, S, Dh) queries over
    (B·Hk, S, Dh) keys and values; it defaults to `ops.flash_attention` (K4 on
    the card), and a check may pass the plain version
    (`repro_torch.kernels.flash_attention.flash_attention_plain`). K4's mask
    is by index, so ``positions`` must be ``arange(S)`` (the reference has
    no caller that passes other positions). Under a grid policy each rank
    attends its own query heads and the row-parallel ``wo`` is summed over
    the model group."""
    B, S, _ = x.shape
    base = torch.arange(S, device=x.device)
    if positions is None:
        positions = base
    elif not torch.equal(positions.to(x.device), base):
        raise NotImplementedError("attention_apply masks by index: positions other than arange(S) are not taken")
    window = S if window is None else int(window)
    q, k, v = _qkv(p, x, cfg, positions, policy)
    hd, h_loc = cfg.head_dim, q.shape[2]
    heads = lambda t: t.transpose(1, 2).reshape(-1, S, hd)       # (B, S, h, Dh) → (B·h, S, Dh)
    out = (kernel or ops.flash_attention)(heads(q), heads(k), heads(v), window=window, causal=True)
    out = out.reshape(B, h_loc, S, hd).transpose(1, 2)            # (B, S, h, Dh)
    return policy.model_psum(out.reshape(B, S, -1) @ p["wo"])


def _partial_softmax(s: torch.Tensor, valid: torch.Tensor, v: torch.Tensor):
    """(max, Σexp, Σexp·v) over the last axis of the scores ``s`` (B, Hk, G,
    S) where ``valid`` (B, 1, 1, S), with values ``v`` (B, S, Hk, Dh) in
    fp32; a row with no valid key gives (−inf, 0, 0)."""
    m = torch.where(valid, s, torch.tensor(float("-inf"), device=s.device)).amax(-1)
    shift = torch.where(torch.isfinite(m), m, torch.zeros((), device=s.device))
    p = torch.exp(s - shift[..., None]) * valid
    return m, p.sum(-1), torch.einsum("bhgs,bshd->bhgd", p, v.float())


def attention_decode(
    p: dict,
    x: torch.Tensor,              # (B, 1, D) current token embedding
    layer_cache: dict,            # {"k","v"}: (B, Smax, Hk, Dh) for THIS layer (the rank's block)
    pos: int | torch.Tensor,      # current position: one for every row, or (B,) one per row
    cfg: AttentionConfig,
    window: int | None = None,
    policy: ShardingPolicy = NO_POLICY,
    span: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step against a per-layer KV cache; returns (out, cache),
    the cache updated in place at each row's position.

    On a sequence-split cache, ``span=(lo, hi)`` scores only the keys at
    global positions ``[lo, hi)``: a rank scores the part of its slice
    inside them, and a rank whose slice misses them gives the empty
    partial."""
    B = x.shape[0]
    hd = cfg.head_dim
    ck, cv = layer_cache["k"], layer_cache["v"]
    per_row = isinstance(pos, torch.Tensor) and pos.ndim == 1
    positions = (pos.to(x.device).long() if per_row else torch.full((B,), int(pos), device=x.device))
    rows = torch.arange(B, device=x.device)
    kind, group, n, r = policy.cache_split()
    q, k, v = _qkv(p, x, cfg, positions[:, None], policy, every_kv=kind == "seq")
    h_loc = q.shape[2]
    Smax = ck.shape[1]
    win = Smax if window is None else int(window)
    if kind == "none" and policy.n_model > 1:
        raise ValueError("a decode under a model size above 1 needs the policy's cache spec "
                         "(launch.shardings.cache_spec)")
    if span is not None and kind != "seq":
        raise ValueError("a span is taken on a sequence-split cache (the policy's cache spec)")
    if kind != "seq":
        ck[rows, positions] = k[:, 0]
        cv[rows, positions] = v[:, 0]
        Hk = ck.shape[2]
        qg = q.reshape(B, Hk, h_loc // Hk, hd) * (hd ** -0.5)
        s = torch.einsum("bhgd,bshd->bhgs", qg, ck).float()
        k_pos = torch.arange(Smax, device=x.device)[None, :]
        valid = (k_pos <= positions[:, None]) & (k_pos > positions[:, None] - win)
        s = torch.where(valid[:, None, None, :], s, torch.tensor(NEG_INF, device=x.device))
        w = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgs,bshd->bhgd", w.to(cv.dtype), cv)
        return policy.model_psum(out.reshape(B, 1, h_loc * hd) @ p["wo"]), {"k": ck, "v": cv}

    # Sequence-split cache: this rank holds positions [r·Smax, (r + 1)·Smax) of every kv head.
    from repro_torch.dist.policy import all_reduce_max, psum

    _, lo, hi, kv_sharded = local_heads(cfg, policy)
    q_all = policy.model_gather(q, dim=2)                          # (B, 1, H, Dh)
    if kv_sharded:
        k, v = policy.model_gather(k, dim=2), policy.model_gather(v, dim=2)
    start = r * Smax
    mine = ((positions >= start) & (positions < start + Smax))[:, None, None]
    at = (positions - start).clamp(0, Smax - 1)
    # Only the rows whose position falls in this slice write; the others
    # write back what they read (no mask-sized index: the same on every device).
    ck[rows, at] = torch.where(mine, k[:, 0], ck[rows, at])
    cv[rows, at] = torch.where(mine, v[:, 0], cv[rows, at])
    Hk = cfg.n_kv_heads
    span_lo, span_hi = (start, start + Smax) if span is None else span
    keys = slice(min(max(span_lo - start, 0), Smax), max(min(span_hi - start, Smax), 0))
    k_pos = start + torch.arange(keys.start, max(keys.stop, keys.start), device=x.device)[None, :]
    qg = q_all.reshape(B, Hk, cfg.q_groups, hd) * (hd ** -0.5)
    if keys.stop > keys.start:
        s = torch.einsum("bhgd,bshd->bhgs", qg, ck[:, keys]).float()
        valid = ((k_pos <= positions[:, None]) & (k_pos > positions[:, None] - win))[:, None, None, :]
        m, l, acc = _partial_softmax(s, valid, cv[:, keys])
    else:                                                          # the slice misses the span: the empty partial
        m = torch.full((B, Hk, cfg.q_groups), float("-inf"), device=x.device)
        l, acc = torch.zeros_like(m), torch.zeros((B, Hk, cfg.q_groups, hd), device=x.device)
    if n > 1:
        scale = torch.exp(m - all_reduce_max(m, group))
        l, acc = psum(l * scale, group), psum(acc * scale[..., None], group)
    out = (acc / l[..., None]).to(x.dtype).reshape(B, cfg.n_heads, hd)
    first = policy.model_index * h_loc
    out = out[:, first:first + h_loc].reshape(B, 1, h_loc * hd)
    return policy.model_psum(out @ p["wo"]), {"k": ck, "v": cv}
