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
`lm_decode_step` updates the cache in place and returns it.

The policy is `NO_POLICY` or a grid policy
(`repro_torch.launch.shardings.lm_policy`, bound to the rank), under
which every function computes the reference's cell on the rank's shards
(`repro_torch.launch.shardings.lm_param_specs`): tensor-parallel attention
and SwiGLU FFN over the model group (`repro_torch.nn.attention`), the
expert-parallel MoE FFN (`repro_torch.nn.moe`), a vocab-parallel embedding
(a masked lookup of the rank's rows, summed over the model group) and
vocab-sharded logits, replicated norms (their input enters the sharded
products through `replicate`, so their gradient comes out whole), and the
batch split over the data group. `lm_forward` and `lm_prefill` return the
rank's vocab shard of the logits, as the reference's cell's out-spec
``P(da, "model")`` does; `lm_loss` takes a vocab-parallel logsumexp (the
max all-reduced, Σexp summed, the gold logit from the rank that holds
it) and averages over the global batch (a `psum` over the data group:
each rank's gradient is its share, and the shares are summed over the
data group by `repro_torch.train.optimizer.data_parallel`). A halo
policy is refused: it is the GCN's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.nn.attention import AttentionConfig, attention_apply, attention_decode, attention_init
from repro_torch.nn.layers import Draw, init_tree, params_from_numpy, rms_norm, silu
from repro_torch.nn.moe import MoEConfig, moe_apply, moe_param_plan
from repro_torch.train.tree import tree_map

__all__ = ["LMConfig", "GLOBAL_WINDOW", "lm_param_plan", "lm_init", "params_from_numpy", "lm_forward", "lm_loss", "lm_prefill",
           "lm_decode_step", "lm_init_cache", "decode_layers"]

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
    if policy.comm == "halo":
        raise NotImplementedError("the LM takes NO_POLICY or a grid policy (launch.shardings.lm_policy); "
                                  "a halo policy is the GCN's")


# --------------------------------------------------------------------- params
def lm_param_plan(cfg: LMConfig) -> dict:
    """The LM's leaves with the reference's layer-stacked shapes and scales.
    The MoE leaves are stacked as the reference's ``tree_map(jnp.stack)``
    stacks them: ``layers.moe.router`` (L, D, E), ``w_gate`` / ``w_up``
    (L, E, D, F), ``w_down`` (L, E, F, D). A seeded draw takes the stacked
    leaves per layer (and per expert), the vocab leaves in 64 row blocks."""
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.attn.head_dim
    std_in, std_out = (1.0 / d) ** 0.5, (1.0 / f) ** 0.5
    vb = 64 if V % 64 == 0 else 1

    def stacked(shape, std):
        return Draw((L, *shape), std=std, units=(L,) + (1,) * len(shape))

    layers = {
        "attn": {
            "wq": stacked((d, cfg.n_heads * hd), std_in),
            "wk": stacked((d, cfg.n_kv_heads * hd), std_in),
            "wv": stacked((d, cfg.n_kv_heads * hd), std_in),
            "wo": stacked((cfg.n_heads * hd, d), std_in),
        },
        "ln1": Draw((L, d), "ones"),
        "ln2": Draw((L, d), "ones"),
    }
    if cfg.is_moe:
        layers["moe"] = moe_param_plan(cfg.moe_cfg(), n_layers=L)
    else:
        layers["mlp"] = {"w_gate": stacked((d, f), std_in), "w_up": stacked((d, f), std_in),
                         "w_down": stacked((f, d), std_out)}
    plan = {"embed": Draw((V, d), std=0.02, units=(vb, 1)), "layers": layers, "final_norm": Draw((d,), "ones")}
    if not cfg.tie_embeddings:
        plan["lm_head"] = Draw((d, V), std=0.02, units=(1, vb))
    return plan


def lm_init(generator: torch.Generator, cfg: LMConfig, dtype=torch.float32,
            device: str | torch.device | None = None) -> dict:
    """`lm_param_plan` drawn on ``generator``'s device (a CUDA generator
    draws gemma3-12b's 46.5 GB on the card), then moved to ``device``
    (``None``: the CUDA card)."""
    return init_tree(generator, lm_param_plan(cfg), dtype, device)


def _layer(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return tree_map(lambda leaf: leaf[i], params["layers"])


def _head(params: dict, cfg: LMConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig, policy: ShardingPolicy) -> torch.Tensor:
    """The scaled embedding of ``tokens``; vocab-parallel under a model size
    above 1: each rank looks up the ids in its row range (zeros for the
    rest) and the rows are summed over the model group."""
    table, tokens = params["embed"], tokens.long()
    if policy.n_model > 1:
        v_loc = table.shape[0]
        local = tokens - policy.model_index * v_loc
        mine = (local >= 0) & (local < v_loc)
        rows = table[local.clamp(0, v_loc - 1)] * mine[..., None].to(table.dtype)
        x = policy.model_psum(rows)
    else:
        x = table[tokens]
    return x * (cfg.d_model ** 0.5)


def _logits(params: dict, h: torch.Tensor, cfg: LMConfig, policy: ShardingPolicy) -> torch.Tensor:
    """The rank's vocab shard of ``h``'s logits (all of them unsharded)."""
    return policy.model_replicate(h) @ _head(params, cfg)


# -------------------------------------------------------------------- forward
def _ffn(layer_p: dict, x2: torch.Tensor, cfg: LMConfig,
         policy: ShardingPolicy = NO_POLICY) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x2.shape
    if cfg.is_moe:
        out, aux = moe_apply(layer_p["moe"], x2.reshape(B * S, D), cfg.moe_cfg(), policy=policy)
        return out.reshape(B, S, D), aux
    m = layer_p["mlp"]
    x2 = policy.model_replicate(x2)
    h = silu(x2 @ m["w_gate"]) * (x2 @ m["w_up"])
    return policy.model_psum(h @ m["w_down"]), torch.zeros((), dtype=torch.float32, device=x2.device)


def _block(x: torch.Tensor, layer_p: dict, cfg: LMConfig, win: int, kernel,
           policy: ShardingPolicy) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer: (its output, its auxiliary loss)."""
    h = rms_norm(x, layer_p["ln1"])
    x = x + attention_apply(layer_p["attn"], h, cfg.attn, window=win, kernel=kernel, policy=policy)
    f, a = _ffn(layer_p, rms_norm(x, layer_p["ln2"]), cfg, policy)
    return x + f, a


def _trunk(params: dict, tokens: torch.Tensor, cfg: LMConfig, kernel,
           policy: ShardingPolicy) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding and every layer: (the last hidden state before the final
    norm (B, S, D), the summed auxiliary loss)."""
    x = _embed(params, tokens, cfg, policy)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i, win in enumerate(cfg.window_sizes()):
        layer_p = _layer(params, i)
        if remat:
            x, a = checkpoint(_block, x, layer_p, cfg, int(win), kernel, policy, use_reentrant=False)
        else:
            x, a = _block(x, layer_p, cfg, int(win), kernel, policy)
        aux = aux + a
    return x, aux


def lm_forward(
    params: dict,
    tokens: torch.Tensor,               # (B, S) int
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    kernel=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V) — the rank's vocab shard under a model size
    above 1 —, aux_loss). ``kernel`` is the attention of every layer
    (`attention_apply`'s; default K4 through `ops.flash_attention`)."""
    _check_policy(policy)
    x, aux = _trunk(params, tokens, cfg, kernel, policy)
    return _logits(params, rms_norm(x, params["final_norm"]), cfg, policy), aux


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor, policy: ShardingPolicy) -> torch.Tensor:
    """Per-token logsumexp minus the gold logit over fp32 logits; over the
    model group's vocab shards: the max all-reduced (no gradient: the
    logsumexp does not depend on it), Σexp summed, and the gold logit from
    the rank whose rows hold it."""
    if policy.n_model == 1:
        return torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    v_loc = logits.shape[-1]
    shift = policy.model_max(logits.detach().amax(-1))
    lse = shift + torch.log(policy.model_psum(torch.exp(logits - shift[..., None]).sum(-1)))
    local = labels - policy.model_index * v_loc
    mine = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0] * mine
    return lse - policy.model_psum(gold)


def lm_loss(
    params: dict,
    tokens: torch.Tensor,               # (B, S + 1) int
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    aux_weight: float = 0.01,
    kernel=None,
) -> torch.Tensor:
    """Next-token cross entropy over the fp32 logits (logsumexp minus the
    gold logit, averaged over (B, S) — the global batch under a data size
    above 1), plus ``aux_weight`` times the summed load-balance loss of the
    MoE layers."""
    logits, aux = lm_forward(params, tokens[:, :-1], cfg, policy, kernel=kernel)
    ce = torch.mean(_cross_entropy(logits.float(), tokens[:, 1:].long(), policy))
    if policy.n_data > 1:
        ce = policy.data_psum(ce) / policy.n_data
    return ce + aux_weight * aux


# -------------------------------------------------------------------- serving
def lm_prefill(
    params: dict,
    tokens: torch.Tensor,
    cfg: LMConfig,
    policy: ShardingPolicy = NO_POLICY,
    kernel=None,
) -> torch.Tensor:
    """Prefill: logits for the LAST position only (the serving quantity),
    (B, V) — the rank's vocab shard under a model size above 1; the head is
    applied to that position alone."""
    _check_policy(policy)
    x, _ = _trunk(params, tokens, cfg, kernel, policy)
    return _logits(params, rms_norm(x[:, -1], params["final_norm"]), cfg, policy)


def lm_init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.float32,
                  device: str | torch.device | None = None, policy: ShardingPolicy = NO_POLICY) -> dict:
    """Zero K and V caches (L, batch, max_len, Hk, Dh); under a grid policy
    with a cache spec, the rank's block of them (``batch`` is the global
    batch)."""
    hd = cfg.attn.head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    if policy.cache is not None:
        from repro_torch.launch.shardings import shard_slices

        coords = policy.grid.coords(policy.data_index * policy.n_model + policy.model_index)
        shape = tuple(s.stop - s.start for s in shard_slices(shape, policy.cache, coords))
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_layers(params: dict, cache: dict, tokens: torch.Tensor, positions, cfg: LMConfig,
                  policy: ShardingPolicy = NO_POLICY) -> torch.Tensor:
    """One decode step of every layer at ``positions`` (an int for every
    row, or (B,) one per row): the fp32 logits (B, V) — the rank's vocab
    shard under a model size above 1 —, the cache written in place."""
    _check_policy(policy)
    x = _embed(params, tokens, cfg, policy)[:, None, :]
    for i, win in enumerate(cfg.window_sizes()):
        layer_p = _layer(params, i)
        h = rms_norm(x, layer_p["ln1"])
        h, _ = attention_decode(layer_p["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]}, positions, cfg.attn,
                                window=int(win), policy=policy)
        x = x + h
        f, _ = _ffn(layer_p, rms_norm(x, layer_p["ln2"]), cfg, policy)
        x = x + f
    x = rms_norm(x, params["final_norm"])
    return _logits(params, x[:, 0], cfg, policy).float()


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
    return decode_layers(params, cache, token.to(params["embed"].device), int(pos), cfg, policy), cache
