"""Public wrappers around the port's kernels — twin of `repro.kernels.ops`.

`bsr_spmm` and `fused_gcn_layer` pad the feature rows to the block grid and
are `torch.autograd.Function`s whose backward is the reference's custom VJP
(`_bsr_diff_bwd`, `_fused_diff_bwd`): the backward of a blocked product is
the blocked-transpose product, written as a batched matmul of the
transposed tiles and an `index_add_` over ``cols`` on the forward's own
ragged tables, so no transposed block structure is built. Only the forward
dispatches on the tensors' device: CPU tensors run the plain PyTorch
versions, CUDA tensors the hand-written kernels of
`repro_torch.kernels.fused_gcn` and `repro_torch.kernels.bsr_spmm`, or raise.
The backward is the same code on both devices; its aggregation-first
recompute M = Ã·X goes through the `bsr_spmm` forward (K1 on the card).

Under `jax.jit` the reference's unused cotangents are dropped by XLA; eager
PyTorch computes whatever the backward asks for, so it asks only for the
gradients ``ctx.needs_input_grad`` names. At Nell's widths ``dvals`` over
the padded table would be 10 GB and layer 1's ``dx`` 1.4 GB, and training
needs neither. Valid tiles only are read or written: padding stays unread.

There is no lane padding and no feature tile to pick (both were TPU
constraints); the kernels take any width and set their own limits. The
plain matmuls of the backward are `torch.matmul` in full fp32 (TF32 is
off by default in PyTorch and callers keep it off).

`fused_gcn_layer` takes the (vals, x, w) dtype combinations of K2's
kernels — all fp32, (fp32, bf16, fp32) and all bf16 — and its backward
takes the reference's casts: the cotangent and every product in fp32,
each gradient returned in its operand's dtype. The aggregation-first
recompute M = Ã·X runs K1 on the operands' own dtypes, as the reference
does: for a bf16 X, M is bf16 and its running sum is rounded to bf16 after
every tile (the reference's bf16 output block), not once at the end.
`bsr_spmm` takes (vals, z) fp32 and fp32, fp32 and bf16, or bf16 and bf16
and returns z's dtype; its backward returns dz in z's dtype and dvals in
vals' dtype, each computed in fp32, as the reference's `_bsr_diff_bwd`.

`fm_interaction` is DeepFM's second-order FM term (K3 on the card,
`repro_torch.kernels.fm_interaction`). The reference has no backward
kernel for it (its gradient is JAX's autodiff of the formula), so its
backward is the analytic gradient in torch ops on both devices:
d out[b] / d emb[b, f, d] = s[b, d] − emb[b, f, d], with s the field sum.
The reference wrapper halves ``b_tile`` until it divides B; the kernel
takes any B, so the port's wrapper has no tile argument.

`flash_attention` is the LM's causal / sliding-window attention over
(BH, S, d) (K4 on the card, `repro_torch.kernels.flash_attention`). The
reference's K4 has no VJP (its models differentiate `_chunked_attention`),
so the port's gradient is `flash_attention_vjp`, the gradient of the
function K4 computes, in torch ops on both devices: when a gradient is
recorded the call goes through `_FlashAttention`, whose forward is K4 on
CUDA tensors (the plain version on CPU tensors) and whose backward launches
no K4; under `torch.no_grad` / `inference_mode` it is the bare forward. Its
k and v may have BH / G rows for G query heads per key/value head
(grouped-query attention, no copy per group). The kernel takes any S, so
the reference's ``bq`` / ``bk`` tile arguments and its ``interpret`` flag
have no counterpart.

Each kernel's entry is a `torch.library` custom op (``repro_torch::k1_bsr_spmm``,
``k2_fused_gcn_layer``, ``k3_fm_interaction``, ``k4_flash_attention``), as
are the blocked-transpose backward's two tile products
(``repro_torch::bsr_t_apply``, ``bsr_dvals``). Each has a fake (meta)
implementation, so the dry run (`repro_torch.launch.dryrun`) traces a
step on the meta device, and a FLOP formula
(`torch.utils.flop_counter.register_flop_formula`) that counts what the
kernel executes over its table's shape (every tile of a (R, T) table, valid
or not; for an attention, every (query, key) pair of the k-tiles K4 visits,
`repro_torch.kernels.flash_attention.k_tiles`, which skips the tiles that
the causal mask or the window leaves empty), so that
``FlopCounterMode`` counts the same work on the meta device and on the
card. A CPU tensor still takes the plain version and a CUDA tensor the
kernel or an exception; under ``FlopCounterMode`` a custom op is one
operation, whichever runs inside it.
"""
from __future__ import annotations

import torch

from typing import Optional

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.bsr_spmm import bsr_spmm as bsr_spmm_cuda
from repro_torch.kernels.flash_attention import flash_attention as flash_attention_cuda
from repro_torch.kernels.flash_attention import (
    K4_BLOCK_ROWS,
    K4_TILE_KEYS,
    flash_attention_plain,
    flash_attention_vjp,
    k_tiles,
)
from repro_torch.kernels.fm_interaction import fm_interaction as fm_interaction_cuda
from repro_torch.kernels.fm_interaction import fm_interaction_plain
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain, k1_name
from repro_torch.kernels.fused_gcn import (
    check_af_resident,
    fused_gcn_layer_cuda,
    fused_gcn_layer_plain,
    operand_suffix,
)
from repro_torch.obs import trace as _obs_trace

__all__ = ["bsr_spmm", "fused_gcn_layer", "fm_interaction", "flash_attention", "kernel_flops"]

_ORDERS = ("feature_first", "aggregation_first")


def _pad_rows(z: torch.Tensor, block: int) -> torch.Tensor:
    """Row-pad a dense operand to the block grid (zero rows); an empty one
    (a k = 1 rank's halo block) to one block, the one column block its
    table has."""
    pad = (-z.shape[0]) % block or (block if z.shape[0] == 0 else 0)
    if not pad:
        return z.contiguous()
    with _obs_trace.span("kernels.pad_rows"):
        return torch.cat([z, z.new_zeros((pad,) + tuple(z.shape[1:]))])


def _on_device(kernel: str, plain, cuda, *args, **kw) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors (the
    meta device takes each custom op's fake implementation instead)."""
    device = args[0].device
    if device.type == "cpu":
        return plain(*args, **kw)
    if device.type != "cuda":
        raise ValueError(f"{kernel} has no kernel for device {device}")
    return cuda(*args, **kw)


# ------------------------------------------------------------- custom ops
def _prod(shape) -> int:
    out = 1
    for n in shape:
        out *= int(n)
    return out


def _k4_pairs(S: int, window: Optional[int], causal: bool, dtype: torch.dtype) -> int:
    """The (query, key) pairs of one head that K4's body computes: for each
    q-tile, its rows times the keys of the k-tiles it visits (`k_tiles`),
    rows and keys past S not counted. The bf16 body's tiles for bf16, the
    fp32 body's for any other dtype (``k4::block_rows``)."""
    body = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    bq, bk = K4_BLOCK_ROWS[body], K4_TILE_KEYS[body]
    window = S if window is None else int(window)
    pairs = 0
    for q0 in range(0, S, bq):
        kt = k_tiles(q0, S, window, causal, body)
        pairs += min(bq, S - q0) * (min(kt.stop * bk, S) - kt.start * bk)
    return pairs


def kernel_flops(name: str, *shapes, order: str = "feature_first", window: Optional[int] = None,
                 causal: bool = True, dtype: torch.dtype = torch.float32) -> int:
    """The FLOP formula of a kernel's custom op over its operands' shapes
    (what ``FlopCounterMode`` adds for one call): ``k1_bsr_spmm`` (vals,
    z), ``k2_fused_gcn_layer`` (vals, x, w) with ``order``,
    ``k3_fm_interaction`` (emb), ``k4_flash_attention`` (q) with
    ``window``, ``causal`` and q's ``dtype``, and the backward's
    ``bsr_t_apply`` / ``bsr_dvals`` (vals, the row cotangent)."""
    if name in ("k1_bsr_spmm", "bsr_t_apply", "bsr_dvals"):
        (R, T, B, _), z = shapes
        return 2 * R * T * B * B * int(z[-1])                 # every tile of the table: a B×B by B×F product
    if name == "k2_fused_gcn_layer":
        (R, T, B, _), x, w = shapes
        f_in, f_out = int(w[0]), int(w[1])
        if order == "feature_first":                          # Z = X·W over X's padded rows, then Ã·Z
            return 2 * int(x[0]) * f_in * f_out + 2 * R * T * B * B * f_out
        return 2 * R * T * B * B * f_in + 2 * R * B * f_in * f_out
    if name == "k3_fm_interaction":
        Bt, F, D = (int(n) for n in shapes[0])
        return 3 * Bt * F * D + 3 * Bt * D                    # Σe and Σe² over fields, then ½(s² − q) over D
    if name == "k4_flash_attention":
        bh, S, d = (int(n) for n in shapes[0])
        return 4 * bh * d * _k4_pairs(S, window, causal, dtype)   # Q·Kᵀ and P·V over the visited pairs
    raise KeyError(name)


@torch.library.custom_op("repro_torch::k1_bsr_spmm", mutates_args=())
def _k1_op(vals: torch.Tensor, cols: torch.Tensor, lens: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return _on_device("bsr_spmm", bsr_spmm_plain, bsr_spmm_cuda, vals, cols, lens, z)


@_k1_op.register_fake
def _(vals, cols, lens, z):
    return z.new_empty((vals.shape[0] * vals.shape[2], z.shape[1]))


@register_flop_formula(torch.ops.repro_torch.k1_bsr_spmm)
def _(vals, cols, lens, z, *args, out_shape=None, **kwargs) -> int:
    return kernel_flops("k1_bsr_spmm", vals, z)


@torch.library.custom_op("repro_torch::k2_fused_gcn_layer", mutates_args=())
def _k2_op(vals: torch.Tensor, cols: torch.Tensor, lens: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor, order: str, relu: bool) -> torch.Tensor:
    return _on_device("fused_gcn_layer", fused_gcn_layer_plain, fused_gcn_layer_cuda,
                      vals, cols, lens, x, w, b, order=order, relu=relu)


@_k2_op.register_fake
def _(vals, cols, lens, x, w, b, order, relu):
    return x.new_empty((vals.shape[0] * vals.shape[2], w.shape[1]))


@register_flop_formula(torch.ops.repro_torch.k2_fused_gcn_layer)
def _(vals, cols, lens, x, w, b, order, relu, *args, out_shape=None, **kwargs) -> int:
    return kernel_flops("k2_fused_gcn_layer", vals, x, w, order=order)


@torch.library.custom_op("repro_torch::k3_fm_interaction", mutates_args=())
def _k3_op(emb: torch.Tensor) -> torch.Tensor:
    return _on_device("fm_interaction", fm_interaction_plain, fm_interaction_cuda, emb)


@_k3_op.register_fake
def _(emb):
    return emb.new_empty((emb.shape[0],))


@register_flop_formula(torch.ops.repro_torch.k3_fm_interaction)
def _(emb, *args, out_shape=None, **kwargs) -> int:
    return kernel_flops("k3_fm_interaction", emb)


@torch.library.custom_op("repro_torch::k4_flash_attention", mutates_args=())
def _k4_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int], causal: bool) -> torch.Tensor:
    return _on_device("flash_attention", flash_attention_plain, flash_attention_cuda, q, k, v,
                      window=window, causal=causal)


@_k4_op.register_fake
def _(q, k, v, window, causal):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.k4_flash_attention, get_raw=True)
def _(q, k, v, window, causal, *args, out_val=None, **kwargs) -> int:
    return kernel_flops("k4_flash_attention", q.shape, window=window, causal=causal, dtype=q.dtype)


def _check_devices(kernel: str, cols, lens, tensors: dict) -> None:
    device = tensors["vals"].device
    for t in (cols, lens, *tensors.values()):
        if t.device != device:
            raise ValueError(f"{kernel}: operands on {device} and {t.device}")


def _tile_mask(cols: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(R, T) validity mask of the ragged tile tables."""
    return torch.arange(cols.shape[1], device=cols.device)[None, :] < lens[:, None]


@torch.library.custom_op("repro_torch::bsr_t_apply", mutates_args=())
def _bsr_t_apply(vals: torch.Tensor, cols: torch.Tensor, lens: torch.Tensor, g: torch.Tensor,
                 n_z_rows: int) -> torch.Tensor:
    """Blocked-transpose apply: dZ[c] = Σ_{(r,t): cols[r,t]=c} vals[r,t]ᵀ·g[r].

    ``g`` is (R·B, F) row-cotangents. Returns (n_z_rows, F). Only valid
    tiles (``t < lens[r]``) are read.
    """
    with _obs_trace.span("sync.tile_index"):
        r_idx, t_idx = _tile_mask(cols, lens).nonzero(as_tuple=True)
    R, _, B, _ = vals.shape
    F = g.shape[-1]
    contrib = torch.bmm(vals[r_idx, t_idx].float().transpose(1, 2), g.reshape(R, B, F)[r_idx])
    dz = g.new_zeros((n_z_rows // B, B, F)).index_add_(0, cols[r_idx, t_idx].long(), contrib)
    return dz.reshape(n_z_rows, F)


@_bsr_t_apply.register_fake
def _(vals, cols, lens, g, n_z_rows):
    return g.new_empty((n_z_rows, g.shape[-1]))


@register_flop_formula(torch.ops.repro_torch.bsr_t_apply)
def _(vals, cols, lens, g, n_z_rows, *args, out_shape=None, **kwargs) -> int:
    return kernel_flops("bsr_t_apply", vals, g)


@torch.library.custom_op("repro_torch::bsr_dvals", mutates_args=())
def _bsr_dvals(vals: torch.Tensor, cols: torch.Tensor, lens: torch.Tensor, g: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """dvals[r,t] = g[r] · Z[cols[r,t]]ᵀ on valid tiles, zero on padding,
    in fp32 of vals' (R, T, B, B) shape."""
    with _obs_trace.span("sync.tile_index"):
        r_idx, t_idx = _tile_mask(cols, lens).nonzero(as_tuple=True)
    R, T, B, _ = vals.shape
    F = z.shape[-1]
    zb = z.reshape(-1, B, F)[cols[r_idx, t_idx].long()].float()
    dvals = g.new_zeros((R, T, B, B))
    dvals[r_idx, t_idx] = torch.bmm(g.reshape(R, B, F)[r_idx], zb.transpose(1, 2))
    return dvals


@_bsr_dvals.register_fake
def _(vals, cols, lens, g, z):
    return g.new_empty(tuple(vals.shape))


@register_flop_formula(torch.ops.repro_torch.bsr_dvals)
def _(vals, cols, lens, g, z, *args, out_shape=None, **kwargs) -> int:
    return kernel_flops("bsr_dvals", vals, g)


# --------------------------------------------------------- bsr_spmm (+ VJP)
def _bsr_forward(vals, cols, lens, z) -> torch.Tensor:
    return _k1_op(vals, cols, lens, z)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, cols, lens, z):
        ctx.save_for_backward(vals, cols, lens, z)
        return _bsr_forward(vals, cols, lens, z)

    @staticmethod
    def backward(ctx, g):
        """`_bsr_diff_bwd` of the reference, for the operands that ask."""
        vals, cols, lens, z = ctx.saved_tensors
        need_vals, need_z = ctx.needs_input_grad[0], ctx.needs_input_grad[3]
        g = g.float()
        dvals = _bsr_dvals(vals, cols, lens, g, z).to(vals.dtype) if need_vals else None
        dz = _bsr_t_apply(vals, cols, lens, g, z.shape[0]).to(z.dtype) if need_z else None
        return dvals, None, None, dz


def bsr_spmm(vals, cols, z, lens=None) -> torch.Tensor:
    """Ragged block-sparse Ã·Z (DESIGN.md §2), differentiable in vals and z.

    Pads the rows of ``z`` to the block grid; the output has ``R·B`` rows
    (the receiver block grid — fewer than ``z``'s rows for the rectangular
    halo tables). ``lens=None`` treats every tile as valid (dense-T:
    padding tiles are zero, so the result is the same). (vals, z) are fp32
    and fp32, fp32 and bf16, or bf16 and bf16; the output has z's dtype.
    """
    R, T, B, _ = vals.shape
    if lens is None:
        lens = torch.full((R,), T, dtype=torch.int32, device=vals.device)
    k1_name(vals.dtype, z.dtype)          # raises on a combination K1 does not take
    _check_devices("bsr_spmm", cols, lens, {"vals": vals, "z": z})
    return _BsrSpmm.apply(vals, cols, lens, _pad_rows(z, B))


# -------------------------------------------------- fused_gcn_layer (+ VJP)
class _FusedGcnLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, cols, lens, x, w, b, order, relu):
        out = _k2_op(vals, cols, lens, x, w, b.float(), order, relu)
        ctx.order, ctx.relu = order, relu
        ctx.save_for_backward(vals, cols, lens, x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        """`_fused_diff_bwd` of the reference: dpre = g·act'(pre) in fp32,
        then the two matmul transposes — the aggregation transpose is
        `_bsr_t_apply`, and aggregation-first recomputes M = Ã·X through
        the `bsr_spmm` forward. Each gradient leaves in its operand's dtype."""
        vals, cols, lens, x, w, out = ctx.saved_tensors
        need_vals, _, _, need_x, need_w, need_b = ctx.needs_input_grad[:6]
        g = g.float()
        if ctx.relu:
            g = g * (out > 0)       # act' from the saved output: relu(pre) > 0 ⇔ pre > 0
        dvals = dx = dw = None
        db = g.sum(dim=0) if need_b else None   # fp32; autograd casts it to b's dtype
        wf = w.float()
        if ctx.order == "feature_first":
            # pre = Ã·(x@w) + b
            if need_vals:
                z = (x.float() @ wf).to(x.dtype)                         # recompute Z
                dvals = _bsr_dvals(vals, cols, lens, g, z)
            if need_w or need_x:
                dz = _bsr_t_apply(vals, cols, lens, g, x.shape[0])       # Ãᵀ·dpre
                dw = x.float().T @ dz if need_w else None
                dx = dz @ wf.T if need_x else None
        else:
            # pre = (Ã·x)·w + b
            if need_w:
                # M = Ã·X recomputed by K1 on the operands' own dtypes, M in
                # X's dtype (the reference's bsr_spmm_pallas call).
                dw = _bsr_forward(vals, cols, lens, x).float().T @ g
            if need_vals or need_x:
                dm = g @ wf.T                                            # (R·B, F_in)
                dvals = _bsr_dvals(vals, cols, lens, dm, x) if need_vals else None
                dx = _bsr_t_apply(vals, cols, lens, dm, x.shape[0]) if need_x else None
        return (
            None if dvals is None else dvals.to(vals.dtype), None, None,
            None if dx is None else dx.to(x.dtype), None if dw is None else dw.to(w.dtype),
            db, None, None,
        )


def fused_gcn_layer(vals, cols, lens, x, w, b, order: str = "feature_first",
                    relu: bool = True) -> torch.Tensor:
    """One fused GCN layer act(Ã·(X·W) + b) / act((Ã·X)·W + b),
    differentiable in vals, x, w and b.

    ``lens=None`` treats every tile as valid. Returns (R·B, F_out) in X's
    dtype — callers slice to their real node count. (vals, x, w) are all
    fp32, (fp32, bf16, fp32) or all bf16; b is fp32 or bf16.
    """
    R, T, B, _ = vals.shape
    if order not in _ORDERS:
        raise ValueError(f"unknown dataflow order: {order!r}")
    if order == "aggregation_first":
        check_af_resident(w.shape[0], w.shape[1], B)   # the reference's bound, on every device
    if lens is None:
        lens = torch.full((R,), T, dtype=torch.int32, device=vals.device)
    b = b.reshape(-1)
    operand_suffix("fused_gcn_layer", vals.dtype, x.dtype, w.dtype)
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gcn_layer takes a float32 or bfloat16 bias, got {b.dtype}")
    _check_devices("fused_gcn_layer", cols, lens, {"vals": vals, "x": x, "w": w, "b": b})
    return _FusedGcnLayer.apply(vals, cols, lens, _pad_rows(x, B), w, b, order, relu)


# ------------------------------------------------------ fm_interaction (+ VJP)
class _FmInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return _k3_op(emb)

    @staticmethod
    def backward(ctx, g):
        """JAX's autodiff of the reference formula: g[b]·(s[b, d] − e[b, f, d]),
        s = Σ_f e, in fp32 (float64 for a float64 emb), returned in emb's
        dtype."""
        (emb,) = ctx.saved_tensors
        acc = torch.promote_types(emb.dtype, torch.float32)
        e = emb.to(acc)
        s = e.sum(dim=1, keepdim=True)
        return (g.to(acc)[:, None, None] * (s - e)).to(emb.dtype)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """DeepFM's second-order FM term of ``emb`` (B, F, D) → (B,), in emb's
    dtype (fp32 or bf16), differentiable in emb. Any B."""
    if emb.dim() != 3:
        raise ValueError(f"fm_interaction takes (B, F, D) embeddings, got shape {tuple(emb.shape)}")
    if emb.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"fm_interaction takes float32 or bfloat16 embeddings, got {emb.dtype}")
    return _FmInteraction.apply(emb.contiguous())


# ---------------------------------------------------- flash_attention (+ VJP)
def _flash_forward(q, k, v, window, causal) -> torch.Tensor:
    return _k4_op(q, k, v, window, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        out = _flash_forward(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_vjp(q, k, v, out, g, ctx.window, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Causal (optionally sliding-window) attention of q (BH, S, d) over
    k, v (BH / G, S, d), scale d^-0.5, output in q's dtype; ``window`` None
    means S. Differentiable in q, k and v (`flash_attention_vjp`)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, window, causal)
    return _flash_forward(q, k, v, window, causal)
