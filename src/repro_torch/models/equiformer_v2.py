"""EquiformerV2 [arXiv:2306.12059] — equivariant graph attention via eSCN;
twin of `repro.models.equiformer_v2`.

Assigned config: 12 layers, d_hidden=128 (sphere channels), l_max=6,
m_max=2, 8 heads, SO(2)-eSCN convolutions.

  * node features are real-SH irreps flattened to (N, K, C), K=(l_max+1)²,
  * per edge, features rotate into the edge frame (edge ∥ ẑ) with the
    Ivanic–Ruedenberg Wigner matrices (`repro_torch.nn.so3`), where the
    tensor-product convolution reduces to per-|m| SO(2) linear maps limited
    to m ≤ m_max (the eSCN O(L⁶)→O(L³) trick),
  * attention weights come from rotation-invariant scalars (l=0 channels of
    both endpoints + radial basis) through an 8-head MLP + segment softmax,
  * equivariant RMS norm (per-l, over m and channels) and a gated per-l FFN.

Every tensor is built out of place (the SO(2) convolution's m ≤ m_max
components go into zeros with one ``index_copy``), so autograd never sees
a write into a tensor it saved. ``params["layers"]`` is a list of per-layer
dicts, as the reference's. There is no hand-written kernel on this path:
the reference computes the model in ``jnp`` with no Pallas kernel, and the
port in torch ops.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.policy import NO_POLICY, ShardingPolicy
from repro_torch.graph.ops import segment_softmax, segment_sum
from repro_torch.nn.layers import Draw, init_tree, mlp_apply, mlp_plan, params_from_numpy
from repro_torch.nn.so3 import block_diag_apply, block_diag_apply_T, real_sh_rotations, rotation_align_z

__all__ = ["EquiformerV2Config", "equiformer_param_plan", "equiformer_init", "params_from_numpy",
           "equiformer_forward", "equiformer_loss"]


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    """The reference's config, field for field. ``edge_chunk`` bounds the
    (E, K, C) message tensor to (edge_chunk, K, C) a step of an eager loop
    over the edges; ``chunk_unroll`` (the reference unrolls its chunk scan
    for the dry run's costing) is accepted and has no effect: the chunks
    always run as that loop."""

    n_layers: int = 12
    d_hidden: int = 128           # sphere channels C
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 16                # input scalar features per node
    d_out: int = 1
    n_rbf: int = 16
    cutoff: float = 5.0
    edge_chunk: int | None = None   # chunk the (E, K, C) message tensor
    chunk_unroll: bool = False      # no effect in the port (see the docstring)

    @property
    def k_comps(self) -> int:
        return (self.l_max + 1) ** 2

    def m_l_count(self, m: int) -> int:
        """Number of l's carrying component m: l ∈ [m, l_max]."""
        return self.l_max + 1 - m


def _so2_plan(cfg: EquiformerV2Config) -> dict:
    """Per-|m| SO(2) linear maps mixing (l ≥ m) × channels."""
    p = {}
    for m in range(cfg.m_max + 1):
        n = cfg.m_l_count(m) * cfg.d_hidden
        p[f"w{m}_r"] = Draw((n, n), std=(1.0 / n) ** 0.5)
        if m > 0:
            p[f"w{m}_i"] = Draw((n, n), std=(1.0 / n) ** 0.5)
    return p


def _layer_plan(cfg: EquiformerV2Config) -> dict:
    C = cfg.d_hidden
    return {
        "so2": _so2_plan(cfg),
        "radial": mlp_plan([cfg.n_rbf, C, cfg.m_max + 1]),
        "attn": mlp_plan([2 * C + cfg.n_rbf, C, cfg.n_heads]),
        "ffn_scalar": mlp_plan([C, 2 * C, C]),
        "gate": mlp_plan([C, cfg.l_max * C]),
        "ffn_l": Draw((cfg.l_max + 1, C, C), std=(1.0 / C) ** 0.5),
        "norm_g": Draw((cfg.l_max + 1, C), "ones"),
    }


def equiformer_param_plan(cfg: EquiformerV2Config) -> dict:
    """The parameters as a plan (`repro_torch.nn.layers.Draw` leaves): the
    reference's shapes and scales; ``layers`` a list."""
    return {
        "embed": mlp_plan([cfg.d_in, cfg.d_hidden, cfg.d_hidden]),
        "layers": [_layer_plan(cfg) for _ in range(cfg.n_layers)],
        "head": mlp_plan([cfg.d_hidden, cfg.d_hidden, cfg.d_out]),
    }


def equiformer_init(generator: torch.Generator, cfg: EquiformerV2Config, dtype=torch.float32,
                    device: str | torch.device | None = None) -> dict:
    """`equiformer_param_plan` drawn from ``generator``."""
    return init_tree(generator, equiformer_param_plan(cfg), dtype, device)


def _eq_norm(h: torch.Tensor, gamma: torch.Tensor, cfg: EquiformerV2Config) -> torch.Tensor:
    """Equivariant RMS norm: per-l, normalize by RMS over (m, channels)."""
    outs = []
    for l in range(cfg.l_max + 1):
        x = h[:, l * l: l * l + 2 * l + 1, :]
        rms = torch.sqrt(x.square().mean(dim=(1, 2), keepdim=True) + 1e-8)
        outs.append(x / rms * gamma[l][None, None, :])
    return torch.cat(outs, dim=1)


def _rbf(d: torch.Tensor, cfg: EquiformerV2Config) -> torch.Tensor:
    mu = torch.linspace(0.0, cfg.cutoff, cfg.n_rbf, dtype=d.dtype, device=d.device)
    sigma = cfg.cutoff / cfg.n_rbf
    return torch.exp(-(d[:, None] - mu[None, :]).square() / (2 * sigma * sigma))


def _so2_conv(p: dict, x: torch.Tensor, radial: torch.Tensor, cfg: EquiformerV2Config) -> torch.Tensor:
    """eSCN SO(2) convolution in the edge frame.

    x: (E, K, C) rotated features. Output has nonzeros only at m ≤ m_max.
    radial: (E, m_max+1) per-m gains from the distance MLP.
    """
    E, K, C = x.shape
    dev = x.device
    # m = 0: components at index l²+l.
    idx0 = [l * l + l for l in range(cfg.l_max + 1)]
    x0 = x.index_select(1, torch.tensor(idx0, device=dev)).flatten(1)
    idx, parts = [idx0], [((x0 @ p["so2"]["w0_r"]) * radial[:, 0:1]).view(E, len(idx0), C)]
    for m in range(1, cfg.m_max + 1):
        ls = range(m, cfg.l_max + 1)
        idx_p = [l * l + l + m for l in ls]
        idx_m = [l * l + l - m for l in ls]
        xp = x.index_select(1, torch.tensor(idx_p, device=dev)).flatten(1)
        xm = x.index_select(1, torch.tensor(idx_m, device=dev)).flatten(1)
        wr, wi = p["so2"][f"w{m}_r"], p["so2"][f"w{m}_i"]
        g = radial[:, m: m + 1]
        idx += [idx_p, idx_m]
        parts += [((xp @ wr - xm @ wi) * g).view(E, len(idx_p), C),
                  ((xp @ wi + xm @ wr) * g).view(E, len(idx_m), C)]
    # The m ≤ m_max components into zeros, out of place (the reference's .at[:, idx, :].set).
    where = torch.tensor([i for ix in idx for i in ix], device=dev)
    return x.new_zeros((E, K, C)).index_copy(1, where, torch.cat(parts, dim=1))


def _ffn(p: dict, h: torch.Tensor, cfg: EquiformerV2Config) -> torch.Tensor:
    """Gated per-l FFN: scalars get an MLP; l>0 get channel mixing gated by
    sigmoid gates derived from the scalar channel (S2-activation-style)."""
    scal = h[:, 0, :]                                        # (N, C)
    gates = torch.sigmoid(mlp_apply(p["gate"], scal)).reshape(-1, cfg.l_max, cfg.d_hidden)
    outs = [mlp_apply(p["ffn_scalar"], scal)[:, None, :]]
    for l in range(1, cfg.l_max + 1):
        x = h[:, l * l: l * l + 2 * l + 1, :]
        outs.append((x @ p["ffn_l"][l]) * gates[:, l - 1][:, None, :])
    return torch.cat(outs, dim=1)


def equiformer_forward(
    params: dict,
    feats: torch.Tensor,           # (N, d_in) scalar node features
    pos: torch.Tensor,             # (N, 3)
    senders: torch.Tensor,
    receivers: torch.Tensor,
    cfg: EquiformerV2Config,
    policy: ShardingPolicy = NO_POLICY,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    N = feats.shape[0]
    C, K = cfg.d_hidden, cfg.k_comps
    s, r = senders.long(), receivers.long()
    emb = mlp_apply(params["embed"], feats)
    h = torch.cat([emb[:, None, :], emb.new_zeros((N, K - 1, C))], dim=1)

    # Edge geometry (shared across layers). Zero-length edges (self loops /
    # ghost padding) have no direction — masked out, which keeps the model
    # exactly SO(3)-equivariant (a directionless edge carries no l>0 message).
    pos_tab = policy.neighbor_table(pos)
    rel = pos.index_select(0, r) - pos_tab.index_select(0, s)
    dist = torch.linalg.norm(rel, dim=-1) + 1e-9
    edge_ok = (dist > 1e-6).to(feats.dtype)
    if edge_mask is not None:
        edge_ok = edge_ok * edge_mask
    u = rel / dist[:, None]
    D = real_sh_rotations(rotation_align_z(u), cfg.l_max)
    rbf = _rbf(dist, cfg)

    for lp in params["layers"]:
        hn = _eq_norm(h, lp["norm_g"], cfg)
        hn_tab = policy.neighbor_table(hn)
        radial = mlp_apply(lp["radial"], rbf)
        # Attention logits need only invariants — cheap, computed unchunked.
        inv = torch.cat([hn_tab[:, 0, :].index_select(0, s), hn[:, 0, :].index_select(0, r), rbf], dim=-1)
        logits = mlp_apply(lp["attn"], inv)                   # (E, heads)
        if edge_mask is not None:
            # Padding edges must not dilute the softmax of real incoming edges.
            logits = torch.where(edge_mask[:, None] > 0, logits, torch.full_like(logits, -1e30))
        alpha = segment_softmax(logits, r, N)                 # (E, heads)
        # jnp.repeat along the last axis: each head's weight over its C / heads channels.
        alpha_c = alpha.repeat_interleave(C // cfg.n_heads, dim=-1) * edge_ok[:, None]
        if cfg.edge_chunk is None:
            # ---- eSCN message: rotate → SO(2) conv → attn weight → rotate back
            src = block_diag_apply(D, hn_tab.index_select(0, s))
            msg = _so2_conv(lp, src, radial, cfg) * alpha_c[:, None, :]     # (E, K, C)
            agg = segment_sum(block_diag_apply_T(D, msg), r, N)
        else:
            agg = _chunked_messages(lp, hn_tab, D, radial, alpha_c, s, r, N, cfg)
        h = policy.constrain(h + agg, "irrep_hidden")
        # ---- gated equivariant FFN
        hn2 = _eq_norm(h, lp["norm_g"], cfg)
        h = policy.constrain(h + _ffn(lp, hn2, cfg), "irrep_hidden")
    return mlp_apply(params["head"], h[:, 0, :])


def _chunked_messages(lp: dict, hn: torch.Tensor, D: list[torch.Tensor], radial: torch.Tensor,
                      alpha_c: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor, N: int,
                      cfg: EquiformerV2Config) -> torch.Tensor:
    """The messages ``edge_chunk`` edges at a time: the (chunk, K, C) tile
    is the only per-edge irrep tensor of a step. The reference pads the
    edges to a chunk multiple (its scan needs equal steps) with self-edges
    on node 0 of weight 0, which add exactly 0; the eager loop runs the last
    chunk short instead, with the same sums."""
    E, ck = senders.shape[0], cfg.edge_chunk
    acc = hn.new_zeros((N, cfg.k_comps, cfg.d_hidden))
    for lo in range(0, E, ck):
        sl = slice(lo, lo + ck)
        Dc = [d[sl] for d in D]
        src = block_diag_apply(Dc, hn.index_select(0, senders[sl]))
        msg = _so2_conv(lp, src, radial[sl], cfg) * alpha_c[sl][:, None, :]
        acc = acc + segment_sum(block_diag_apply_T(Dc, msg), receivers[sl], N)
    return acc


def equiformer_loss(params, feats, pos, senders, receivers, target, cfg, policy=NO_POLICY) -> torch.Tensor:
    pred = equiformer_forward(params, feats, pos, senders, receivers, cfg, policy)
    return (pred - target).square().mean()
