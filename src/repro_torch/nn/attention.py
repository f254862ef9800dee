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
and returns the same tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.nn.layers import normal

__all__ = [
    "AttentionConfig",
    "attention_init",
    "attention_apply",
    "attention_decode",
    "rope",
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


def _qkv(p: dict, x: torch.Tensor, cfg: AttentionConfig, positions: torch.Tensor):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
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
) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention for the training
    forward and prefill.

    ``kernel`` computes the attention of (B·H, S, Dh) queries over
    (B·Hk, S, Dh) keys and values; it defaults to `ops.flash_attention` (K4 on
    the card), and a check may pass the plain version
    (`repro_torch.kernels.flash_attention.flash_attention_plain`). K4's mask
    is by index, so ``positions`` must be ``arange(S)`` (the reference has
    no caller that passes other positions)."""
    B, S, _ = x.shape
    base = torch.arange(S, device=x.device)
    if positions is None:
        positions = base
    elif not torch.equal(positions.to(x.device), base):
        raise NotImplementedError("attention_apply masks by index: positions other than arange(S) are not taken")
    window = S if window is None else int(window)
    q, k, v = _qkv(p, x, cfg, positions)
    hd = cfg.head_dim
    heads = lambda t: t.transpose(1, 2).reshape(-1, S, hd)       # (B, S, h, Dh) → (B·h, S, Dh)
    out = (kernel or ops.flash_attention)(heads(q), heads(k), heads(v), window=window, causal=True)
    out = out.reshape(B, cfg.n_heads, S, hd).transpose(1, 2)      # (B, S, H, Dh)
    return out.reshape(B, S, -1) @ p["wo"]


def attention_decode(
    p: dict,
    x: torch.Tensor,              # (B, 1, D) current token embedding
    layer_cache: dict,            # {"k","v"}: (B, Smax, Hk, Dh) for THIS layer
    pos: int | torch.Tensor,      # current position
    cfg: AttentionConfig,
    window: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step against a per-layer KV cache; returns (out, cache),
    the cache updated in place at ``pos``."""
    B = x.shape[0]
    hd = cfg.head_dim
    pos = int(pos)
    positions = torch.full((1,), pos, device=x.device)
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    ck, cv = layer_cache["k"], layer_cache["v"]
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    Smax, Hk = ck.shape[1], cfg.n_kv_heads
    G = cfg.q_groups
    win = Smax if window is None else int(window)
    qg = q.reshape(B, Hk, G, hd) * (hd ** -0.5)
    s = torch.einsum("bhgd,bshd->bhgs", qg, ck).float()
    k_pos = torch.arange(Smax, device=x.device)
    valid = (k_pos <= pos) & (k_pos > pos - win)
    s = torch.where(valid[None, None, None], s, torch.tensor(NEG_INF, device=x.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", w.to(cv.dtype), cv)
    out = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"]
    return out, {"k": ck, "v": cv}
