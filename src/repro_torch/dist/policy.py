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
export rows with ``bind_halo``. ``constrain`` is the identity: there is no
mesh to place activations on, and the call keeps the model code in step
with the reference. The hierarchical (pod, model) exchange is not ported
yet (ROADMAP, slice 5).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ShardingPolicy", "NO_POLICY"]


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

    def constrain(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The identity: the port places no activation on a mesh. Kept so
        the model reads like the reference."""
        return x

    # ------------------------------------------------- GNN communication mode
    @property
    def is_halo(self) -> bool:
        """True once halo mode is armed: comm == "halo" AND the rank's export
        rows are bound."""
        return self.comm == "halo" and self.halo_send_idx is not None

    def bind_halo(
        self,
        send_idx: torch.Tensor | None = None,
        *,
        send_loc: torch.Tensor | None = None,
        send_rem: torch.Tensor | None = None,
    ) -> "ShardingPolicy":
        """Copy with this rank's export rows bound: its (s_max,) slice of
        ``HaloPlan.send_idx``. The hierarchical ``send_loc``/``send_rem``
        pair is checked as the reference checks it, then refused: its
        two-phase exchange is not ported yet."""
        if send_idx is not None and (send_loc is not None or send_rem is not None):
            raise ValueError("bind_halo takes send_idx OR (send_loc, send_rem), not both")
        if send_idx is None and (send_loc is None) != (send_rem is None):
            raise ValueError("hierarchical bind_halo needs BOTH send_loc and send_rem")
        if send_idx is None and send_loc is None:
            raise ValueError("bind_halo needs send_idx or the (send_loc, send_rem) pair")
        if send_idx is None:
            raise NotImplementedError(
                "the hierarchical (pod, model) halo exchange is not ported yet: "
                "ROADMAP.md, port slice 5 (hierarchical exchange)"
            )
        return dataclasses.replace(self, halo_send_idx=send_idx)

    def neighbor_table(self, x: torch.Tensor) -> torch.Tensor:
        """The table sender indices gather from.

        Broadcast / NO_POLICY / unbound halo: ``x`` itself (senders are
        global rows). Armed halo: ``[x ‖ halo_exchange(x)]`` of shape
        ``(n_local + k·s_max, d)``, which the plan's re-localized senders
        index — and whose column space is exactly that of the per-rank
        blocked tables of `repro_torch.dist.halo.plan_blocked_rank`."""
        if not self.is_halo:
            return x
        return torch.cat([x, self.halo_block(x)])

    def halo_block(self, x: torch.Tensor) -> torch.Tensor:
        """Just the exchanged halo rows of :meth:`neighbor_table` (armed
        halo only) — the overlapped schedule consumes this directly. The
        wire is encoded per :attr:`halo_payload` and decoded here, so
        callers always see ``x.dtype`` rows."""
        from repro_torch.dist.halo import halo_exchange

        return halo_exchange(
            x, self.halo_send_idx, self.group, via=self.halo_via, payload=self.halo_payload,
        )


#: The unsharded singleton: the identity neighbor table.
NO_POLICY = ShardingPolicy()
