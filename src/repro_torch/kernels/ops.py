"""Public wrappers around the port's graph kernels — twin of `repro.kernels.ops`.

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bsr_spmm import bsr_spmm as bsr_spmm_cuda
from repro_torch.kernels.bsr_spmm import bsr_spmm_plain, k1_name
from repro_torch.kernels.fused_gcn import fused_gcn_layer_cuda, fused_gcn_layer_plain, operand_suffix

__all__ = ["bsr_spmm", "fused_gcn_layer"]

_ORDERS = ("feature_first", "aggregation_first")


def _pad_rows(z: torch.Tensor, block: int) -> torch.Tensor:
    """Row-pad a dense operand to the block grid (zero rows)."""
    pad = (-z.shape[0]) % block
    return torch.cat([z, z.new_zeros((pad,) + tuple(z.shape[1:]))]) if pad else z.contiguous()


def _on_device(kernel: str, plain, cuda, *args, **kw) -> torch.Tensor:
    """The plain version on CPU tensors, the kernel on CUDA tensors."""
    device = args[0].device
    if device.type == "cpu":
        return plain(*args, **kw)
    if device.type != "cuda":
        raise ValueError(f"{kernel} has no kernel for device {device}")
    return cuda(*args, **kw)


def _check_devices(kernel: str, cols, lens, tensors: dict) -> None:
    device = tensors["vals"].device
    for t in (cols, lens, *tensors.values()):
        if t.device != device:
            raise ValueError(f"{kernel}: operands on {device} and {t.device}")


def _tile_mask(cols: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(R, T) validity mask of the ragged tile tables."""
    return torch.arange(cols.shape[1], device=cols.device)[None, :] < lens[:, None]


def _bsr_t_apply(vals, cols, pairs, g: torch.Tensor, n_z_rows: int) -> torch.Tensor:
    """Blocked-transpose apply: dZ[c] = Σ_{(r,t): cols[r,t]=c} vals[r,t]ᵀ·g[r].

    ``pairs`` are the (r, t) indices of the valid tiles; ``g`` is (R·B, F)
    row-cotangents. Returns (n_z_rows, F). Only valid tiles are read.
    """
    r_idx, t_idx = pairs
    R, _, B, _ = vals.shape
    F = g.shape[-1]
    contrib = torch.bmm(vals[r_idx, t_idx].float().transpose(1, 2), g.reshape(R, B, F)[r_idx])
    dz = g.new_zeros((n_z_rows // B, B, F)).index_add_(0, cols[r_idx, t_idx].long(), contrib)
    return dz.reshape(n_z_rows, F)


def _bsr_dvals(shape, cols, pairs, g: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """dvals[r,t] = g[r] · Z[cols[r,t]]ᵀ on valid tiles, zero on padding;
    ``shape`` is vals' (R, T, B, B)."""
    r_idx, t_idx = pairs
    R, _, B, _ = shape
    F = z.shape[-1]
    zb = z.reshape(-1, B, F)[cols[r_idx, t_idx].long()].float()
    dvals = g.new_zeros(shape)
    dvals[r_idx, t_idx] = torch.bmm(g.reshape(R, B, F)[r_idx], zb.transpose(1, 2))
    return dvals


# --------------------------------------------------------- bsr_spmm (+ VJP)
def _bsr_forward(vals, cols, lens, z) -> torch.Tensor:
    return _on_device("bsr_spmm", bsr_spmm_plain, bsr_spmm_cuda, vals, cols, lens, z)


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
        pairs = _tile_mask(cols, lens).nonzero(as_tuple=True)
        g = g.float()
        dvals = _bsr_dvals(vals.shape, cols, pairs, g, z).to(vals.dtype) if need_vals else None
        dz = _bsr_t_apply(vals, cols, pairs, g, z.shape[0]).to(z.dtype) if need_z else None
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
        out = _on_device("fused_gcn_layer", fused_gcn_layer_plain, fused_gcn_layer_cuda,
                         vals, cols, lens, x, w, b.float(), order=order, relu=relu)
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
        pairs = _tile_mask(cols, lens).nonzero(as_tuple=True)
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
                dvals = _bsr_dvals(vals.shape, cols, pairs, g, z)
            if need_w or need_x:
                dz = _bsr_t_apply(vals, cols, pairs, g, x.shape[0])      # Ãᵀ·dpre
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
                dvals = _bsr_dvals(vals.shape, cols, pairs, dm, x) if need_vals else None
                dx = _bsr_t_apply(vals, cols, pairs, dm, x.shape[0]) if need_x else None
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
    if lens is None:
        lens = torch.full((R,), T, dtype=torch.int32, device=vals.device)
    b = b.reshape(-1)
    operand_suffix("fused_gcn_layer", vals.dtype, x.dtype, w.dtype)
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_gcn_layer takes a float32 or bfloat16 bias, got {b.dtype}")
    _check_devices("fused_gcn_layer", cols, lens, {"vals": vals, "x": x, "w": w, "b": b})
    return _FusedGcnLayer.apply(vals, cols, lens, _pad_rows(x, B), w, b, order, relu)
