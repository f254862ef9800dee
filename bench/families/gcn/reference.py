"""The plain reference: the GCN of Kipf & Welling with COIN's fake
quantization, its loss and AdamW, in plain PyTorch on the raw inputs.

It takes the raw edge list, features, labels, mask and weights that the
benchmark made, and works out everything else again: the symmetric graph
with self loops, D^-1/2 (A + I) D^-1/2, the nearest-rank calibration of the
activations, the layers in the original node order. It imports nothing of
the program and calls none of its kernels or helpers.

``tf32=True`` computes every matrix product with its operands rounded to
TF32 (10 mantissa bits, round to nearest, ties away from zero, as the
tensor cores take fp32 operands) and fp32 sums: the control, one precision
below the configurations' fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch


# ------------------------------------------------------------------- TF32
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the backward too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        da = g @ tf32_round(b).T if ctx.needs_input_grad[0] else None
        db = tf32_round(a).T @ g if ctx.needs_input_grad[1] else None
        return da, db


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    return _Tf32Mm.apply(a, b) if tf32 else a @ b


# --------------------------------------------------------------- the graph
class Adjacency:
    """Ã = D^-1/2 (A_sym + I) D^-1/2 over the original node order, as an
    edge list: A_sym holds each raw edge in both directions once."""

    def __init__(self, edge_index: np.ndarray, n_nodes: int, device: torch.device):
        both = np.concatenate([edge_index, edge_index[::-1]], axis=1).astype(np.int64)
        pairs = np.unique(both[0] * n_nodes + both[1])
        loops = np.arange(n_nodes, dtype=np.int64)
        s = np.concatenate([pairs // n_nodes, loops])
        r = np.concatenate([pairs % n_nodes, loops])
        deg_in = np.bincount(r, minlength=n_nodes).astype(np.float64)
        deg_out = np.bincount(s, minlength=n_nodes).astype(np.float64)
        w = (1.0 / np.sqrt(deg_out[s])) * (1.0 / np.sqrt(deg_in[r]))
        self.n_nodes = n_nodes
        self.n_edges = int(s.shape[0])
        self.senders = torch.from_numpy(s).to(device)
        self.receivers = torch.from_numpy(r).to(device)
        self.weight = torch.from_numpy(w.astype(np.float32)).to(device)

    def apply(self, z: torch.Tensor) -> torch.Tensor:
        """Ã · z: each receiver sums its senders' rows times their weights."""
        msg = z[self.senders] * self.weight[:, None]
        return torch.zeros((self.n_nodes, z.shape[1]), dtype=z.dtype, device=z.device).index_add(
            0, self.receivers, msg)


# ------------------------------------------------------------ quantization
def nearest_rank(values: torch.Tensor, percentile: float) -> torch.Tensor:
    """The nearest-rank percentile of non-negative ``values``: the
    ceil(p·n/100)-th smallest, by bisection over the fp32 bit patterns
    (monotone for non-negative floats)."""
    bits = values.reshape(-1).contiguous().view(torch.int32)
    n = bits.numel()
    rank = min(n, max(1, math.ceil(percentile / 100.0 * n)))
    lo, hi = 0, 0x7F800000
    while lo < hi:
        mid = (lo + hi) // 2
        if int((bits <= mid).sum()) >= rank:
            hi = mid
        else:
            lo = mid + 1
    return torch.tensor([lo], dtype=torch.int32).view(torch.float32)[0].to(values.device)


def quant_scale(x: torch.Tensor, bits: int, percentile: float | None = None) -> torch.Tensor:
    """scale = amax / (2^(bits-1) - 1): amax the largest magnitude of ``x``,
    or the nearest-rank percentile of the magnitudes (1 where amax is 0)."""
    mag = x.detach().abs()
    amax = mag.max() if percentile is None else nearest_rank(mag, percentile)
    return amax / float(2 ** (bits - 1) - 1) if float(amax) > 0 else torch.ones_like(amax)


def quant_codes(x: torch.Tensor, bits: int, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale), half to even, clipped to [-2^(bits-1), 2^(bits-1) - 1]."""
    qmax = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(x.detach() / scale), -qmax - 1, qmax)


def ties(own: torch.Tensor, other: torch.Tensor, tol: float) -> torch.Tensor:
    """Elements at which two runs' values of one tensor agree within ``tol``
    of its largest magnitude: where a step function of them still differs,
    the two sides sit on either side of a step, and rounding chose."""
    return (own.detach() - other.detach().float()).abs() <= tol * float(own.detach().abs().max())


# ----------------------------------------------------------------- the model
class GCN:
    """A configuration's GCN over one dataset, in the original node order."""

    def __init__(self, model: dict, adjacency: Adjacency, tf32: bool = False):
        self.dims = tuple(model["layer_dims"])
        self.quant = model.get("quant")
        self.adj = adjacency
        self.tf32 = tf32
        self.followed = dict(weight_codes=0, act_codes=0, relu_mask=0)    # elements taken at ties

    def fake_quant(self, x: torch.Tensor, bits: int, percentile: float | None, follow: torch.Tensor | None,
                   tol: float, kind: str) -> torch.Tensor:
        """Symmetric per-tensor fake quantization, straight-through gradient:
        the codes of `quant_codes` times the scale of `quant_scale`; at the
        ties of ``x`` with ``follow``, the codes that ``follow`` takes."""
        scale = quant_scale(x, bits, percentile)
        codes = quant_codes(x, bits, scale)
        if follow is not None:
            other = quant_codes(follow.float(), bits, quant_scale(follow.float(), bits, percentile))
            tie = ties(x, follow, tol) & (other != codes)
            self.followed[kind] += int(tie.sum())
            codes = torch.where(tie, other, codes)
        return x + (codes * scale - x).detach()

    @property
    def n_layers(self) -> int:
        return len(self.dims) - 1

    def layer(self, i: int, params: dict, h: torch.Tensor, follow_in: torch.Tensor | None = None,
              follow_out: torch.Tensor | None = None, follow_w: torch.Tensor | None = None,
              tol: float = 0.0) -> torch.Tensor:
        """Layer ``i`` on input ``h``. Three steps of the layer are step
        functions whose ties are common: a 4-bit code of the input exactly
        between two levels and a pre-activation summing to exactly 0 (the
        graph's lattice of values makes both), and a weight's 4-bit code
        where two runs' weights differ by rounding after an update. So the
        order of a sum decides them. To follow another run through those
        ties alone: ``follow_in`` and ``follow_w``, that run's input and
        weight, give their 4-bit codes at each element where the two runs'
        values agree within ``tol`` (`ties`) and the codes differ;
        ``follow_out``, that run's output, gives the ReLU's gradient mask
        where the outputs so agree and the masks differ. Every other element,
        and every value and gradient, is this layer's own."""
        w, b = params[f"w{i}"], params[f"b{i}"]
        if self.quant:
            w = self.fake_quant(w, int(self.quant["weight_bits"]), None, follow_w, tol, "weight_codes")
            h = self.fake_quant(h, int(self.quant["act_bits"]), self.quant.get("act_percentile"), follow_in, tol,
                                "act_codes")
        d_in, d_out = w.shape
        if d_out <= d_in:
            h = self.adj.apply(matmul(h, w, self.tf32))
        else:
            h = matmul(self.adj.apply(h), w, self.tf32)
        h = h + b
        if i == self.n_layers - 1:
            return h
        out = torch.relu(h)
        if follow_out is None:
            return out
        own, other = h.detach() > 0, follow_out.detach() > 0
        tie = ties(out, follow_out, tol) & (own != other)
        self.followed["relu_mask"] += int(tie.sum())
        mask = torch.where(tie, other, own).to(h.dtype)
        return h * mask + (out - h * mask).detach()

    def forward(self, params: dict, x: torch.Tensor, follow: list | None = None, follow_params: dict | None = None,
                tol: float = 0.0) -> list[torch.Tensor]:
        """Every layer's output; the last is the logits. ``follow``: another
        run's outputs of every layer but the last, ``follow_params`` its
        parameters, whose ties `layer` follows within ``tol``."""
        outs, h = [], x
        for i in range(self.n_layers):
            last = i == self.n_layers - 1
            h = self.layer(i, params, h,
                           follow_in=None if (i == 0 or follow is None) else follow[i - 1],
                           follow_out=None if (last or follow is None) else follow[i],
                           follow_w=None if follow_params is None else follow_params[f"w{i}"], tol=tol)
            outs.append(h)
        return outs


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the masked nodes."""
    gold = logits.gather(1, labels[:, None])[:, 0]
    return ((torch.logsumexp(logits, dim=1) - gold) * mask).sum() / mask.sum()


def adamw_step(params: dict, grads: dict, state: dict, opt: dict) -> dict:
    """One AdamW step (decoupled weight decay, bias-corrected moments)."""
    t = state["t"] = state.get("t", 0) + 1
    b1, b2 = opt["b1"], opt["b2"]
    out = {}
    for k, p in params.items():
        m = state.setdefault("m", {}).get(k, torch.zeros_like(p)) * b1 + (1 - b1) * grads[k]
        v = state.setdefault("v", {}).get(k, torch.zeros_like(p)) * b2 + (1 - b2) * grads[k] * grads[k]
        state["m"][k], state["v"][k] = m, v
        update = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
        out[k] = p - opt["lr"] * (update + opt["weight_decay"] * p)
    return out


def train(model: GCN, params: dict, x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
          opt: dict, steps: int, follow: dict | None = None, tol: float = 0.0) -> dict:
    """``steps`` full-batch AdamW steps: each step's loss, hidden layers'
    outputs and parameters, the first step's gradient and the parameters
    after the last step. ``follow``: another run's ``hidden`` outputs and
    ``step_params`` at each step, whose ties step t follows within ``tol``
    (`GCN.layer`)."""
    state, losses, hidden, step_params, first = {}, [], [], [], None
    for t in range(steps):
        step_params.append({k: p.detach() for k, p in params.items()})
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        outs = model.forward(leaves, x, None if follow is None else follow["hidden"][t],
                             None if follow is None else follow["step_params"][t], tol)
        loss = cross_entropy(outs[-1], labels, mask)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        hidden.append([o.detach() for o in outs[:-1]])
        first = first if first is not None else {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            params = adamw_step({k: p.detach() for k, p in leaves.items()}, grads, state, opt)
    return dict(losses=losses, hidden=hidden, step_params=step_params, first_grad=first, params=params,
                followed=dict(model.followed))
