"""DeepFM [arXiv:1703.04247] — FM interaction ∥ deep MLP over shared field
embeddings; twin of `repro.models.deepfm`.

Configuration: n_sparse = 39 fields, embed_dim = 10, MLP 400-400-400, FM
interaction (`repro_torch.configs.deepfm`). Serving scores a batch of
examples (`deepfm_forward`), retrieval scores one user against many
candidates as one batched product (`deepfm_retrieval`), and training
minimizes `deepfm_loss` (binary cross-entropy on click labels).

The second-order term uses the linearized identity
    Σ_{i<j} ⟨v_i, v_j⟩ = ½ (‖Σ_i v_i‖² − Σ_i ‖v_i‖²)      — O(F·D), not O(F²·D).

One change of route, and no change of function: the reference computes that
term with its own jnp expression (`repro.models.deepfm.fm_interaction`);
here `fm_interaction` is `repro_torch.kernels.ops.fm_interaction`, which
computes the same function — its plain version on CPU tensors, the CUDA
kernel K3 (`repro_torch.kernels.fm_interaction`) on CUDA tensors. Its
gradient is the one JAX's autodiff of the expression gives.

Parameters are a dict tree with the reference's keys (`table`, `w_linear`,
`bias`, `mlp/l{i}/{w,b}`, `user_tower`, `item_proj`); `params_from_numpy`
carries the reference's across. `user_tower` and `item_proj` serve
retrieval only: the loss does not reach them, so their gradients are zero
(and AdamW's weight decay still moves them), as in the reference. The only
policy taken is `NO_POLICY`: a row-sharded table is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.kernels import ops
from repro_torch.nn.layers import mlp_apply, mlp_init, normal
from repro_torch.recsys.embedding import field_lookup
from repro_torch.train.tree import tree_map

__all__ = ["DeepFMConfig", "deepfm_init", "params_from_numpy", "fm_interaction", "deepfm_forward",
           "deepfm_loss", "deepfm_retrieval"]


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    n_fields: int = 39
    embed_dim: int = 10
    mlp_dims: tuple[int, ...] = (400, 400, 400)
    rows_per_field: int = 100_000     # hashed bucket size per field
    d_tower: int = 64                 # retrieval tower width

    @property
    def total_rows(self) -> int:
        return self.n_fields * self.rows_per_field

    @property
    def field_offsets(self) -> np.ndarray:
        return np.arange(self.n_fields, dtype=np.int32) * self.rows_per_field


def deepfm_init(generator: torch.Generator, cfg: DeepFMConfig, dtype=torch.float32,
                device: str | torch.device | None = None) -> dict:
    """Random parameters, drawn on ``generator``'s device (a CUDA generator
    draws the 39 M-row table of the full config on the card), then moved to
    ``device`` (``None``: the CUDA card)."""
    device = resolve_device(device)
    dims = [cfg.n_fields * cfg.embed_dim, *cfg.mlp_dims, 1]
    return {
        "table": normal(generator, (cfg.total_rows, cfg.embed_dim), dtype, device) * 0.01,
        "w_linear": normal(generator, (cfg.total_rows,), dtype, device) * 0.01,
        "bias": torch.zeros((), dtype=dtype, device=device),
        "mlp": mlp_init(generator, dims, dtype, device),
        "user_tower": mlp_init(generator, [cfg.n_fields * cfg.embed_dim, cfg.d_tower], dtype, device),
        "item_proj": normal(generator, (cfg.embed_dim, cfg.d_tower), dtype, device) * 0.1,
    }


def params_from_numpy(params: dict, device: str | torch.device | None = None) -> dict:
    """The reference's `deepfm_init` tree (as numpy arrays) as the port's, so
    that both packages compute the same thing."""
    device = resolve_device(device)
    return tree_map(lambda v: torch.from_numpy(np.array(v)).to(device), params)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B,) second-order FM term (K3 on the card)."""
    return ops.fm_interaction(emb)


def _check_policy(policy: ShardingPolicy) -> None:
    if policy is not NO_POLICY:
        raise NotImplementedError("DeepFM takes only NO_POLICY in the port: a row-sharded table is a later slice")


def deepfm_forward(
    params: dict,
    ids: torch.Tensor,                         # (B, F) per-field hashed ids
    cfg: DeepFMConfig,
    policy: ShardingPolicy = NO_POLICY,
    fm_term: Callable[[torch.Tensor], torch.Tensor] = fm_interaction,
) -> torch.Tensor:
    """(B,) click logits. ``fm_term`` computes the FM term; a check may pass
    the plain version (`repro_torch.kernels.fm_interaction.fm_interaction_plain`)
    to hold K3's logits against it."""
    _check_policy(policy)
    ids = ids.to(torch.int64)
    offs = torch.from_numpy(cfg.field_offsets).to(ids.device, torch.int64)
    emb = field_lookup(params["table"], ids, offs)     # (B, F, D)
    first = params["w_linear"].index_select(0, (ids + offs[None, :]).reshape(-1)).reshape(ids.shape).sum(-1)
    second = fm_term(emb)
    deep = mlp_apply(params["mlp"], emb.reshape(ids.shape[0], -1))[:, 0]
    return first + second + deep + params["bias"]


def deepfm_loss(params, ids, labels, cfg, policy=NO_POLICY, fm_term=fm_interaction) -> torch.Tensor:
    """Binary cross-entropy on click labels, the reference's stable logit
    form: clip the logits to ±30, then max(z, 0) − z·y + log1p(exp(−|z|))."""
    z = deepfm_forward(params, ids, cfg, policy, fm_term).clamp(-30.0, 30.0)
    return (torch.maximum(z, torch.zeros_like(z)) - z * labels + torch.log1p(torch.exp(-z.abs()))).mean()


def deepfm_retrieval(
    params: dict,
    user_ids: torch.Tensor,                    # (B, F)
    cand_ids: torch.Tensor,                    # (B, Ncand) item ids (field 0)
    cfg: DeepFMConfig,
    policy: ShardingPolicy = NO_POLICY,
) -> torch.Tensor:
    """Retrieval scoring: the user tower against N candidates as one batched
    product (the ``retrieval_cand`` shape: 1 query × 1,000,000 candidates)."""
    _check_policy(policy)
    offs = torch.from_numpy(cfg.field_offsets).to(user_ids.device, torch.int64)
    emb = field_lookup(params["table"], user_ids, offs)
    u = mlp_apply(params["user_tower"], emb.reshape(user_ids.shape[0], -1))          # (B, T)
    cand = params["table"].index_select(0, cand_ids.reshape(-1).to(torch.int64))
    cand = cand.reshape(*cand_ids.shape, cfg.embed_dim) @ params["item_proj"]         # (B, N, T)
    return torch.einsum("bt,bnt->bn", u, cand)
