"""The sharding policy the model reads — twin of `repro.dist.policy`.

A :class:`ShardingPolicy` carries the GNN **communication mode**:

* ``comm="broadcast"`` — the paper's Fig. 5c schedule. In the port there is
  no mesh that could insert the layer-output all-gathers, so this mode is
  the unsharded forward: ``neighbor_table`` is the identity.
* ``comm="halo"`` — the sharded full-graph schedule: each rank of a
  `torch.distributed` group runs the model on its block of a
  :class:`~repro_torch.dist.halo.HaloPlan` layout, and
  ``neighbor_table(h)`` returns ``[local ‖ halo]`` — the rank's block plus
  the exchanged boundary rows — which plan-relocalized senders index.

The reference names a mesh axis; the port names a process group (``None``
is the default group). Models call ``policy.neighbor_table(x)`` before
every sender-side gather and work identically under both modes (and under
:data:`NO_POLICY`). The halo mode only activates once the rank binds its
export rows with ``bind_halo``: a flat plan's ``send_idx``, or a
hierarchical plan's ``send_loc``/``send_rem`` pair, whose two-phase
exchange runs over ``halo_groups``, the rank's (pod, model) subgroups
(`repro_torch.launch.mesh.halo_groups`; the reference's ``halo_axes``).
``constrain`` is the identity: there is no mesh to place activations on,
and the call keeps the model code in step with the reference.

Training under halo needs two more pieces of the reference's ``shard_map``
(`replicate` and `psum`, and the policy's methods of those names). There
the parameters are closed over, so the transpose of their broadcast sums
each device's gradient over the mesh axis; and the loss is
``psum(wsum) / psum(wcnt)``, whose ``psum`` (under ``check_vma=False``)
hands each device's cotangent back to its own term. `replicate` is the
identity with an all-reduce (sum) over the group as its backward, `psum`
an all-reduce (sum) whose backward is the identity: together every rank
gets the unsharded gradient, and no other gradient all-reduce is needed.
Both run over ``group``, the whole group, under the hierarchical exchange
too: the reference's ``psum`` over both the pod and the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["ShardingPolicy", "NO_POLICY", "replicate", "psum"]


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the ranks of ``group`` of ``x`` (a new tensor), through the
    host where the backend carries host tensors only (gloo)."""
    from repro_torch.dist.halo import _wire_on_host

    on_host = _wire_on_host(x, group)
    out = (x.detach().cpu() if on_host else x.detach()).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device) if on_host else out


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate(x: torch.Tensor, group=None) -> torch.Tensor:
    """A parameter every rank of ``group`` holds alike: the identity, whose
    backward sums the ranks' gradients (the transpose of the reference's
    closed-over, replicated parameters)."""
    return _Replicate.apply(x, group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``group`` (``jax.lax.psum``), whose
    backward hands each rank's cotangent back to its own term, as JAX
    transposes ``psum`` under ``check_vma=False``."""
    return _Psum.apply(x, group)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The GNN communication mode (broadcast vs halo) and, for halo, the
    process group, the wire format and the schedule of the exchange."""

    group: Any = None                  # torch.distributed group; None = the default group
    comm: str = "broadcast"            # "broadcast" | "halo"
    halo_via: str = "all_gather"       # collective lowering (see halo_exchange)
    halo_send_idx: Any = None          # (s_max,) rank export rows; bound via bind_halo
    halo_payload: str | None = None    # wire format: None/"fp32" | "bf16" | "int8"
    halo_overlap: bool = True          # split interior/boundary aggregation
    halo_groups: Any = None            # hierarchical: this rank's (pod group, model group)
    halo_send_loc: Any = None          # hierarchical (s_loc,) intra-pod export rows
    halo_send_rem: Any = None          # hierarchical (s_rem,) inter-pod export rows

    def constrain(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The identity: the port places no activation on a mesh. Kept so
        the model reads like the reference."""
        return x

    # ------------------------------------------------- GNN communication mode
    @property
    def is_halo(self) -> bool:
        """True once halo mode is armed: comm == "halo" AND the rank's export
        rows (flat, or the hierarchical pair) are bound."""
        return self.comm == "halo" and (
            self.halo_send_idx is not None
            or (self.halo_send_loc is not None and self.halo_send_rem is not None)
        )

    def bind_halo(
        self,
        send_idx: torch.Tensor | None = None,
        *,
        send_loc: torch.Tensor | None = None,
        send_rem: torch.Tensor | None = None,
    ) -> "ShardingPolicy":
        """Copy with this rank's export rows bound.

        Flat: pass ``send_idx``, the rank's (s_max,) slice of
        ``HaloPlan.send_idx``. Hierarchical: pass the keyword pair
        ``send_loc``/``send_rem``, the rank's (s_loc,) and (s_rem,) slices
        of ``HaloPlan.send_loc``/``send_rem``; ``neighbor_table`` then runs
        the two-phase exchange over ``halo_groups``. Exactly one of the two
        forms must be given."""
        if send_idx is not None and (send_loc is not None or send_rem is not None):
            raise ValueError("bind_halo takes send_idx OR (send_loc, send_rem), not both")
        if send_idx is None and (send_loc is None) != (send_rem is None):
            raise ValueError("hierarchical bind_halo needs BOTH send_loc and send_rem")
        if send_idx is None and send_loc is None:
            raise ValueError("bind_halo needs send_idx or the (send_loc, send_rem) pair")
        return dataclasses.replace(
            self, halo_send_idx=send_idx, halo_send_loc=send_loc, halo_send_rem=send_rem
        )

    def neighbor_table(self, x: torch.Tensor) -> torch.Tensor:
        """The table sender indices gather from.

        Broadcast / NO_POLICY / unbound halo: ``x`` itself (senders are
        global rows). Armed flat halo: ``[x ‖ halo_exchange(x)]`` of shape
        ``(n_local + k·s_max, d)``; armed hierarchical halo: ``[x ‖
        hier_halo_exchange(x)]`` of shape ``(n_local + k_model·(s_loc +
        n_pods·s_rem), d)``. Either way the plan's re-localized senders
        index it, and its column space is exactly that of the per-rank
        blocked tables of `repro_torch.dist.halo.plan_blocked_rank`."""
        if not self.is_halo:
            return x
        return torch.cat([x, self.halo_block(x)])

    def replicate(self, params: dict) -> dict:
        """``params`` as the parameters every rank holds alike (armed halo:
        :func:`replicate` of each; otherwise themselves)."""
        if not self.is_halo:
            return params
        return {name: replicate(p, self.group) for name, p in params.items()}

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`psum` over the group (armed halo; otherwise ``x``)."""
        return psum(x, self.group) if self.is_halo else x

    def halo_block(self, x: torch.Tensor) -> torch.Tensor:
        """Just the exchanged halo rows of :meth:`neighbor_table` (armed
        halo only) — the overlapped schedule consumes this directly. The
        wire is encoded per :attr:`halo_payload` and decoded here, so
        callers always see ``x.dtype`` rows."""
        from repro_torch.dist.halo import halo_exchange, hier_halo_exchange

        if self.halo_send_loc is not None:
            if self.halo_groups is None:
                raise ValueError("a hierarchical halo binding needs halo_groups, the rank's "
                                 "(pod group, model group) from repro_torch.launch.mesh.halo_groups")
            return hier_halo_exchange(
                x, self.halo_send_loc, self.halo_send_rem, self.halo_groups,
                via=self.halo_via, payload=self.halo_payload,
            )
        return halo_exchange(
            x, self.halo_send_idx, self.group, via=self.halo_via, payload=self.halo_payload,
        )


#: The unsharded singleton: the identity neighbor table.
NO_POLICY = ShardingPolicy()
