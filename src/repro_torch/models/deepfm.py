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
(and AdamW's weight decay still moves them), as in the reference.

The policy is `NO_POLICY` or a grid policy
(`repro_torch.launch.shardings.recsys_policy`, bound to the rank): then
``table`` and ``w_linear`` are row-sharded over the model group (each
lookup masks the ids outside the rank's rows and sums over the group:
`repro_torch.recsys.embedding.sharded_rows`), the MLP, ``user_tower``,
``item_proj`` and ``bias`` are replicated, the batch is split over the
data group and the loss is the mean over the global batch. K3 runs on the
rank's (B/n_data, F, D). In retrieval the candidate ids are split over
the model group (the reference's ``P(None, "model")``): a candidate's row
may live on another rank, so the ids are gathered, looked up masked, and
the sum over the group is scattered (`reduce_scatter`): each rank
receives, projects and scores its own slice.
A halo policy is refused: it is the GCN's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.kernels import ops
from repro_torch.nn.layers import Draw, init_tree, mlp_apply, mlp_plan, params_from_numpy
from repro_torch.recsys.embedding import field_lookup, owned_rows, sharded_rows

__all__ = ["DeepFMConfig", "deepfm_param_plan", "deepfm_init", "params_from_numpy", "fm_interaction", "deepfm_forward",
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


def deepfm_param_plan(cfg: DeepFMConfig) -> dict:
    """DeepFM's leaves with the reference's shapes and scales; a seeded draw
    takes the table and ``w_linear`` per field."""
    F, D = cfg.n_fields, cfg.embed_dim
    return {
        "table": Draw((cfg.total_rows, D), std=0.01, units=(F, 1)),
        "w_linear": Draw((cfg.total_rows,), std=0.01, units=(F,)),
        "bias": Draw((), "zeros"),
        "mlp": mlp_plan([F * D, *cfg.mlp_dims, 1]),
        "user_tower": mlp_plan([F * D, cfg.d_tower]),
        "item_proj": Draw((D, cfg.d_tower), std=0.1),
    }


def deepfm_init(generator: torch.Generator, cfg: DeepFMConfig, dtype=torch.float32,
                device: str | torch.device | None = None) -> dict:
    """`deepfm_param_plan` drawn on ``generator``'s device (a CUDA generator
    draws the 39 M-row table of the full config on the card), then moved to
    ``device`` (``None``: the CUDA card)."""
    return init_tree(generator, deepfm_param_plan(cfg), dtype, device)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) → (B,) second-order FM term (K3 on the card)."""
    return ops.fm_interaction(emb)


def _check_policy(policy: ShardingPolicy) -> None:
    if policy.comm == "halo":
        raise NotImplementedError("DeepFM takes NO_POLICY or a grid policy (launch.shardings.recsys_policy); "
                                  "a halo policy is the GCN's")


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
    emb = field_lookup(params["table"], ids, offs, policy)     # (B, F, D)
    first = sharded_rows(params["w_linear"], (ids + offs[None, :]).reshape(-1), policy).reshape(ids.shape).sum(-1)
    second = fm_term(emb)
    deep = mlp_apply(params["mlp"], emb.reshape(ids.shape[0], -1))[:, 0]
    return first + second + deep + params["bias"]


def deepfm_loss(params, ids, labels, cfg, policy=NO_POLICY, fm_term=fm_interaction) -> torch.Tensor:
    """Binary cross-entropy on click labels, the reference's stable logit
    form: clip the logits to ±30, then max(z, 0) − z·y + log1p(exp(−|z|)),
    averaged over the global batch."""
    z = deepfm_forward(params, ids, cfg, policy, fm_term).clamp(-30.0, 30.0)
    loss = (torch.maximum(z, torch.zeros_like(z)) - z * labels + torch.log1p(torch.exp(-z.abs()))).mean()
    return policy.data_psum(loss) / policy.n_data if policy.n_data > 1 else loss


def deepfm_retrieval(
    params: dict,
    user_ids: torch.Tensor,                    # (B, F)
    cand_ids: torch.Tensor,                    # (B, Ncand) item ids (field 0); the rank's slice under a policy
    cfg: DeepFMConfig,
    policy: ShardingPolicy = NO_POLICY,
) -> torch.Tensor:
    """Retrieval scoring: the user tower against N candidates as one batched
    product (the ``retrieval_cand`` shape: 1 query × 1,000,000 candidates);
    under a model size above 1 the rank's slice of the scores."""
    _check_policy(policy)
    offs = torch.from_numpy(cfg.field_offsets).to(user_ids.device, torch.int64)
    emb = field_lookup(params["table"], user_ids, offs, policy)
    u = mlp_apply(params["user_tower"], emb.reshape(user_ids.shape[0], -1))          # (B, T)
    if policy.n_model > 1:
        # A candidate's row may live on any rank: each rank looks up its rows of every candidate, and
        # the sum over the model group is scattered, each rank receiving its own N/k slice.
        every = policy.model_gather(cand_ids.to(torch.int64), dim=1)                 # (B, N)
        mine = owned_rows(params["table"], every.reshape(-1), policy).reshape(*every.shape, cfg.embed_dim)
        cand = policy.model_reduce_scatter(mine, dim=1)                              # (B, N/k, D)
    else:
        cand = params["table"].index_select(0, cand_ids.reshape(-1).to(torch.int64))
        cand = cand.reshape(*cand_ids.shape, cfg.embed_dim)                            # (B, N, D)
    return torch.einsum("bt,bnt->bn", u, cand @ params["item_proj"])
