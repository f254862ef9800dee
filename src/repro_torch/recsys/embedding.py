"""Embedding lookups — twin of `repro.recsys.embedding`:

  * `field_lookup`   — one id per field: a row gather from one concatenated
                       table (`index_select`),
  * `embedding_bag`  — multi-hot bags: gather + `index_add_` (sum / mean),
  * `hash_ids`       — multiplicative hashing into per-field buckets, so any
                       raw id stream maps onto the fixed-size tables,
  * `sharded_rows`   — a row gather from a table row-sharded over the model
                       group (the reference's ``P("model", None)``): each
                       rank gathers the ids in its row range, zeros for the
                       rest, and the rows are summed over the group.

Ids are indexed as int64, converted once per call (the streams hand out
int32). One difference from the reference is kept, not emulated: an id out
of range. ``jnp.take`` fills such a row with NaN and ``segment_sum`` drops
an out-of-range segment; `index_select` and `index_add_` raise on the CPU
and hit a device-side assert on the card. Every id the repository's streams
draw is in range.
"""
from __future__ import annotations

import torch

__all__ = ["embedding_bag", "field_lookup", "hash_ids", "sharded_rows"]

_MASK = 0xFFFFFFFF
_HASH_MULT = 2654435761          # Knuth multiplicative
_SALT_MULT = 0x9E3779B9


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a · m) mod 2³² for 0 ≤ a < 2³² held in int64: the constant is split
    in 16-bit halves so that no product leaves int64."""
    lo = a * (m & 0xFFFF)
    hi = (a * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def hash_ids(raw_ids: torch.Tensor, bucket_size: int, field_salt: torch.Tensor | int = 0) -> torch.Tensor:
    """Hash integer ids into [0, bucket_size) as int32, bit for bit the
    reference's uint32 arithmetic (wrap-around products, ``x ^ (x >> 16)``),
    computed in int64 and masked to 32 bits."""
    x = raw_ids.to(torch.int64) & _MASK
    salt = torch.as_tensor(field_salt, dtype=torch.int64, device=x.device) & _MASK
    x = (x + _mul32(salt, _SALT_MULT)) & _MASK
    x = _mul32(x, _HASH_MULT)
    x = x ^ (x >> 16)
    return (x % bucket_size).to(torch.int32)


def owned_rows(table: torch.Tensor, rows: torch.Tensor, policy) -> torch.Tensor:
    """This rank's share of ``table[rows]`` (int64 ``rows`` of the whole
    table; the rank holds block ``policy.model_index`` of its rows): the
    rows it holds, zeros for the others. Summed over the model group it is
    ``table[rows]``."""
    n = table.shape[0]
    local = rows - policy.model_index * n
    mine = (local >= 0) & (local < n)
    out = table.index_select(0, local.clamp(0, n - 1))
    return out * mine.reshape(-1, *([1] * (out.ndim - 1))).to(out.dtype)


def sharded_rows(table: torch.Tensor, rows: torch.Tensor, policy=None) -> torch.Tensor:
    """``table[rows]`` for int64 ``rows`` of the whole table, where this
    rank holds block ``policy.model_index`` of its rows (all of them
    without a policy or at a model size of 1)."""
    if policy is None or policy.n_model == 1:
        return table.index_select(0, rows)
    return policy.model_psum(owned_rows(table, rows, policy))


def field_lookup(table: torch.Tensor, ids: torch.Tensor, field_offsets: torch.Tensor, policy=None) -> torch.Tensor:
    """ids: (B, F) per-field local ids → (B, F, D) embeddings.

    field_offsets: (F,) starting row of each field's sub-table inside the
    single concatenated table (row-sharded over the model group under a
    grid policy: `sharded_rows`).
    """
    flat = (ids.to(torch.int64) + field_offsets.to(torch.int64)[None, :]).reshape(-1)
    return sharded_rows(table, flat, policy).reshape(ids.shape[0], ids.shape[1], table.shape[1])


def embedding_bag(
    table: torch.Tensor,
    ids: torch.Tensor,            # (nnz,) row ids
    segment_ids: torch.Tensor,    # (nnz,) output bag per id
    num_bags: int,
    weights: torch.Tensor | None = None,
    mode: str = "sum",
) -> torch.Tensor:
    """``torch.nn.EmbeddingBag``'s function as the reference writes it:
    ragged gather + segment sum (an empty bag is zero; ``mean`` divides by
    max(count, 1))."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    rows = table.index_select(0, ids.to(torch.int64))
    if weights is not None:
        rows = rows * weights[:, None]
    seg = segment_ids.to(torch.int64)
    out = rows.new_zeros((num_bags, table.shape[1])).index_add_(0, seg, rows)
    if mode == "mean":
        cnt = rows.new_zeros((num_bags,)).index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out
