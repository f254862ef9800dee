"""Decoder-only transformer LM covering the five assigned LM architectures —
twin of `repro.models.transformer_lm`.

One config-driven implementation provides:
  * a dense SwiGLU or an MoE FFN (moonshot 64e/top-6, olmoe 64e/top-8;
    `repro_torch.nn.moe`),
  * GQA / MQA (granite kv=1),
  * mixed sliding-window / global layers (gemma3 5:1), as the reference's
    per-layer window vector (`LMConfig.window_sizes`),
  * the training forward, `lm_loss` and prefill through the attention
    kernel K4 (`repro_torch.nn.attention.attention_apply`; its gradient is
    `repro_torch.kernels.ops.flash_attention`'s backward), and the KV-cache
    decode path (plain einsum over the cache, as in the reference).

Params are dicts with the reference's layer-stacked leaves (leading axis =
n_layers); the reference's ``lax.scan`` over them is a Python loop over the
layers here, each layer reading views of the stacked leaves. With
``cfg.remat`` each layer runs under `torch.utils.checkpoint.checkpoint`
(non-reentrant), the reference's ``jax.checkpoint`` of the scan body: the
backward recomputes the layer's forward, K4 launches included.
``unroll_layers`` (the reference's dry-run switch) changes nothing in an
eager loop. `params_from_numpy` carries the reference's tree across.
`lm_prefill` applies the final norm and the head to the last position only:
the same values as the reference's ``lm_forward(...)[:, -1]`` without the
(B, S, vocab) logits (4.3 GB at gemma3-12b's vocab and S = 4,096).
`lm_decode_step` updates the cache in place and returns it. The only policy
taken is `NO_POLICY`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.nn.attention import AttentionConfig, attention_apply, attention_decode, attention_init
from repro_torch.nn.layers import normal, rms_norm, silu
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_init
from repro_torch.train.tree import tree_map

__all__ = ["LMConfig", "GLOBAL_WINDOW", "lm_init", "params_from_numpy", "lm_forward", "lm_loss", "lm_prefill",
           "lm_decode_step", "lm_init_cache"]

GLOBAL_WINDOW = np.int32(2**30)  # "window" meaning full causal attention


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    moe_experts: int | None = None
    moe_top_k: int | None = None
    moe_groups: int = 1          # hierarchical dispatch groups (= data shards)
    moe_capacity_factor: float = 1.25
    window: int | None = None          # sliding window for local layers
    global_every: int | None = None    # gemma3: every 6th layer global
    rope_theta: float = 10_000.0
    kv_chunk: int = 1024
    tie_embeddings: bool = True
    # The reference's dry-run switch: an eager layer loop has nothing to unroll.
    unroll_layers: bool = False
    # Rematerialize layer activations in backward (torch.utils.checkpoint of
    # each layer): trades recompute FLOPs for peak memory.
    remat: bool = False

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            rope_theta=self.rope_theta,
            kv_chunk=self.kv_chunk,
        )

    @property
    def is_moe(self) -> bool:
        return self.moe_experts is not None

    @property
    def sub_quadratic(self) -> bool:
        """True iff most layers are sliding-window (long_500k eligibility)."""
        return self.window is not None

    def moe_cfg(self) -> MoEConfig:
        assert self.is_moe
        return MoEConfig(
            num_experts=self.moe_experts,
            top_k=self.moe_top_k,
            d_model=self.d_model,
            d_ff=self.d_ff,
            groups=self.moe_groups,
            capacity_factor=self.moe_capacity_factor,
        )

    def window_sizes(self) -> np.ndarray:
        """Per-layer attention window (int32). Global layers get 2^30."""
        if self.window is None:
            return np.full(self.n_layers, GLOBAL_WINDOW, np.int32)
        ws = np.full(self.n_layers, self.window, np.int32)
        if self.global_every:
            ws[self.global_every - 1 :: self.global_every] = GLOBAL_WINDOW
        return ws

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.d_head or d // self.n_heads
        attn = d * hd * (self.n_heads * 2) + d * hd * (self.n_kv_heads * 2)
        if self.is_moe:
            ffn = d * self.moe_experts + self.moe_experts * 3 * d * f
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d + d

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        hd = self.d_head or d // self.n_heads
        attn = d * hd * (self.n_heads * 2) + d * hd * (self.n_kv_heads * 2)
        ffn = d * self.moe_experts + self.moe_top_k * 3 * d * f
        return self.n_layers * (attn + ffn + 2 * d) + self.vocab * d + d


def _check_policy(policy: ShardingPolicy) -> None:
    if policy is not NO_POLICY:
        raise NotImplementedError("the LM takes only NO_POLICY in the port: a sharded LM is a later slice")


# --------------------------------------------------------------------- params
def lm_init(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32,
            device: str | torch.device | None = None) -> dict:
    """Random parameters with the reference's layer-stacked leaves and
    scales, drawn on ``generator``'s device (a CUDA generator draws
    gemma3-12b's 46.5 GB on the card), then moved to ``device`` (``None``:
    the CUDA card). The MoE leaves are stacked as the reference's
    ``tree_map(jnp.stack)`` stacks them: ``layers.moe.router`` (L, D, E),
    ``w_gate`` / ``w_up`` (L, E, D, F), ``w_down`` (L, E, F, D)."""
    device = resolve_device(device)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd = cfg.attn.head_dim
    std_in, std_out = (1.0 / d) ** 0.5, (1.0 / f) ** 0.5

    def stacked(shape, std):
        return normal(generator, (L, *shape), dtype, device).mul_(std)

    params = {
        "embed": normal(generator, (cfg.vocab, d), dtype, device).mul_(0.02),
        "layers": {
            "attn": {
                "wq": stacked((d, cfg.n_heads * hd), std_in),
                "wk": stacked((d, cfg.n_kv_heads * hd), std_in),
                "wv": stacked((d, cfg.n_kv_heads * hd), std_in),
                "wo": stacked((cfg.n_heads * hd, d), std_in),
            },
            "ln1": torch.ones((L, d), dtype=dtype, device=device),
            "ln2": torch.ones((L, d), dtype=dtype, device=device),
        },
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
    }
    if cfg.is_moe:
        params["layers"]["moe"] = moe_init(generator, cfg.moe_cfg(), dtype, device, n_layers=L)
    else:
        params["layers"]["mlp"] = {
            "w_gate": stacked((d, f), std_in),
            "w_up": stacked((d, f), std_in),
            "w_down": stacked((f, d), std_out),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (d, cfg.vocab), dtype, device).mul_(0.02)
    return params


def params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """The reference's `lm_init` tree (as numpy arrays) as the port's, so that
    both packages compute the same thing."""
    device = resolve_device(device)
    return tree_map(lambda v: torch.from_numpy(np.array(v)).to(device), params)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda leaf: leaf[i], params["layers"])


def _head(params: dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# -------------------------------------------------------------------- forward
def _ffn(layer_p: dict, x2: torch.Tensor, cfg: LMConfig) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x2.shape
    if cfg.is_moe:
        out, aux = moe_apply(layer_p["moe"], x2.reshape(B * S, D), cfg.moe_cfg())
        return out.reshape(B, S, D), aux
    m = layer_p["mlp"]
    h = silu(x2 @ m["w_gate"]) * (x2 @ m["w_up"])
    return h @ m["w_down"], torch.zeros((), dtype=torch.float32, device=x2.device)


def _block(x: torch.Tensor, layer_p: dict, cfg: LMConfig, win: int, kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (its output, its auxiliary loss)."""
    h = rms_norm(x, layer_p["ln1"])
    x = x + attention_apply(layer_p["attn"], h, cfg.attn, window=win, kernel=kernel)
    f, a = _ffn(layer_p, rms_norm(x, layer_p["ln2"]), cfg)
    return x + f, a


def _trunk(params: dict, tokens: torch.Tensor, cfg: LMConfig, kernel) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding and every layer: (the last hidden state before the final
    norm (B, S, D), the summed auxiliary loss)."""
    x = params["embed"][tokens.long()] * (cfg.d_model ** 0.5)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, win in enumerate(cfg.window_sizes()):
        layer_p = _layer(params, i)
        if remat:
            x, a = checkpoint(_block, x, layer_p, cfg, int(win), kernel, use_reentrant=False)
        else:
            x, a = _block(x, layer_p, cfg, int(win), kernel)
        aux = aux + a
    return x, aux


def lm_forward(
    params: dict,
    tokens: torch.Tensor,               # (B, S) int
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    kernel=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V), aux_loss). ``kernel`` is the attention of
    every layer (`attention_apply`'s; default K4 through `ops.flash_attention`)."""
    _check_policy(policy)
    x, aux = _trunk(params, tokens, cfg, kernel)
    return rms_norm(x, params["final_norm"]) @ _head(params, cfg), aux


def lm_loss(
    params: dict,
    tokens: torch.Tensor,               # (B, S + 1) int
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    aux_weight: float = 0.01,
    kernel=None,
) -> torch.Tensor:
    """Next-token cross entropy over the fp32 logits (logsumexp minus the
    gold logit, averaged over (B, S)), plus ``aux_weight`` times the summed
    load-balance loss of the MoE layers."""
    logits, aux = lm_forward(params, tokens[:, :-1], cfg, policy, kernel=kernel)
    labels = tokens[:, 1:].long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold) + aux_weight * aux


# -------------------------------------------------------------------- serving
def lm_prefill(
    params: dict,
    tokens: torch.Tensor,
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    kernel=None,
) -> torch.Tensor:
    """Prefill: logits for the LAST position only (the serving quantity),
    (B, V); the head is applied to that position alone."""
    _check_policy(policy)
    x, _ = _trunk(params, tokens, cfg, kernel)
    return rms_norm(x[:, -1], params["final_norm"]) @ _head(params, cfg)


def lm_init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.float32,
                  device: str | torch.device | None = None) -> dict:
    hd = cfg.attn.head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_decode_step(
    params: dict,
    cache: dict,                        # {"k","v"}: (L, B, Smax, Hk, Dh)
    token: torch.Tensor,                # (B,) int current token ids
    pos: int | torch.Tensor,            # the current position, one for every row
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
) -> tuple[torch.Tensor, dict]:
    """One decode step for all layers; returns (next-token logits (B, V) in
    fp32, the cache), the cache updated in place at ``pos``."""
    _check_policy(policy)
    x = params["embed"][token.long()][:, None, :] * (cfg.d_model ** 0.5)
    for i, win in enumerate(cfg.window_sizes()):
        layer_p = _layer(params, i)
        h = rms_norm(x, layer_p["ln1"])
        h, _ = attention_decode(layer_p["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, pos, cfg.attn,
                                window=int(win))
        x = x + h
        f, _ = _ffn(layer_p, rms_norm(x, layer_p["ln2"]), cfg)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return (x[:, 0] @ _head(params, cfg)).float(), cache
