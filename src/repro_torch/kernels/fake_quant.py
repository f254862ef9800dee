"""The GCN's fake quantization on Hopper, with its plain version (the
PyTorch ops of `repro_torch.core.quant.fake_quant`).

    amax  = the k-th largest |x|, k = n − ⌈p·n/100⌉ + 1 (nearest rank), or max |x|
    scale = amax / qmax where amax > 0, else 1
    out   = x + (clamp(round(x / scale), −qmax − 1, qmax) · scale − x)

over x in fp32 or bf16, every operation rounded as the plain version's ops
round it on the card. The CUDA source is ``csrc/fake_quant_kernels.cuh``
(kernels) and ``csrc/fake_quant.cu`` (launchers).

Source note
-----------
**Replaces** no Pallas kernel: the JAX package leaves fake quant to XLA
(``src/repro/core/quant.py::fake_quant``). It replaces the PyTorch ops the
port ran on the card — ``abs``, ``torch.topk`` (or ``max``), ``where``,
``div``, ``round``, ``clamp``, ``mul``, ``sub``, ``add`` — which made about
eight full passes over X and a radix select that read it several times
more: 15 ms of each 4-bit Nell request.

**What bounds it on the H100: bytes.** At Nell's X (65,755 × 5,414 fp32,
1.424 GB) the least is X read once and the output written once: 2.85 GB,
0.85 ms at 3.35 TB/s.

**What the design does about it.** An exact radix select on the
magnitudes' bits (three digit passes in fp32, two in bf16) that skips exact
zeros (99.33 % of X) and, while the first pass reads X, copies its nonzero
elements (bits and positions) into a scratch buffer, so that the other
passes read 9.6 MB instead of 1.4 GB; the last block of each pass picks
the digit on the card, and every decision — which bin, whether the
elements fitted the buffer, whether the statistic is a zero — stays there:
the host reads nothing and never waits. A zero quantizes to +0 whatever a
finite, positive scale, so the percentile's output starts zeroed and,
where every nonzero element fitted, the quantize kernel writes only those;
else it reads x and writes the output in 16-byte vectors. With
``percentile=None`` (the weights) the statistic is a max reduction.

The wrapper allocates the output (zeroed for the percentile), the zeroed
workspace and the scratch buffer (`scratch_capacity` elements); the
kernels allocate nothing and never synchronise. ``LAUNCHES`` counts each
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import library

__all__ = ["LAUNCHES", "reset_launch_counts", "rank_k", "scratch_capacity", "digit_passes", "fake_quant",
           "fake_quant_plain"]

_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}
_KEY_BITS = {torch.float32: 31, torch.bfloat16: 15}
_KERNELS = ("fq_max_pass", "fq_select_pass", "fq_quantize")

LAUNCHES = {f"{k}{sfx}": 0 for sfx in _SUFFIX.values() for k in _KERNELS}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rank_k(n: int, percentile: float) -> int:
    """The nearest-rank percentile's place from the largest: the
    ceil(p·n/100)-th smallest is the (n − ceil(p·n/100) + 1)-th largest,
    kept within [1, n]."""
    return min(n, max(1, n - math.ceil(percentile / 100.0 * n) + 1))


def scratch_capacity(n: int) -> int:
    """Elements the scratch buffer holds (their bits and positions): all of
    a tensor up to 2**20 elements, n / 32 of a larger one (X's 2.4 M
    nonzero elements in 11.1 M places)."""
    return min(n, max(1 << 20, n >> 5))


def digit_passes(kb: int) -> int:
    """Digit passes of a key of ``kb`` bits: 11 bits from the top, then 10
    (fp32: 3, bf16: 2)."""
    return 1 + (kb - 11 + 9) // 10


def fake_quant_plain(x: torch.Tensor, bits: int, percentile: float | None = None) -> torch.Tensor:
    """The PyTorch ops (1 ≤ bits < 32): the statistic by `torch.topk` (or
    max) on the magnitudes, which carry no gradient; half-to-even rounding,
    the clip [−qmax − 1, qmax]; a straight-through gradient."""
    qmax = float(2 ** (bits - 1) - 1)
    mag = x.detach().abs()
    if percentile is None:
        amax = mag.max()
    else:
        flat = mag.reshape(-1)
        amax = torch.topk(flat, rank_k(int(flat.shape[0]), percentile)).values[-1]
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax) * scale
    # Straight-through estimator: forward q, backward identity.
    return x + (q - x).detach()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("fake_quant")
    P, L, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"fq_fake_quant{sfx}")
        fn.argtypes, fn.restype = [P, P, L, F, F, F, L, P, P, L, P], ctypes.c_int
    lib.fq_state_words.argtypes, lib.fq_state_words.restype = [], ctypes.c_longlong
    lib.fq_passes.argtypes, lib.fq_passes.restype = [ctypes.c_int], ctypes.c_int
    lib.fq_error_string.argtypes, lib.fq_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, bits: int, percentile: float | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, the kernels' workspace) — the workspace's word 1 holds the
    scale's bits once the call has run."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"fake_quant's kernel takes float32 or bfloat16 tensors, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"fake_quant's kernel takes CUDA tensors, got {x.device}")
    if not 1 <= bits < 32:
        raise ValueError(f"fake_quant's kernel takes 1 ≤ bits < 32, got {bits}")
    x = x.contiguous()
    n = x.numel()
    if not 1 <= n < 2**31:
        raise ValueError(f"fake_quant's kernel takes 1 ≤ numel < 2**31, got {n}")
    qmax = float(2 ** (bits - 1) - 1)
    k = 0 if percentile is None else rank_k(n, percentile)
    lib = _lib()
    state = torch.zeros(lib.fq_state_words(), dtype=torch.int32, device=x.device)
    cap = scratch_capacity(n) if k else 0
    scratch = torch.empty(max(2 * cap, 1), dtype=torch.int32, device=x.device)
    # The percentile's output starts zeroed: the kernels write only the nonzero elements where they fit the buffer.
    out = torch.zeros_like(x) if k else torch.empty_like(x)
    sfx = _SUFFIX[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, f"fq_fake_quant{sfx}")(x.data_ptr(), out.data_ptr(), n, qmax, -qmax - 1, qmax, k,
                                             state.data_ptr(), scratch.data_ptr(), cap, stream)
    if err:
        raise RuntimeError(f"fq_fake_quant{sfx}: CUDA error {err} ({lib.fq_error_string(err).decode()})")
    if k:
        LAUNCHES[f"fq_select_pass{sfx}"] += digit_passes(_KEY_BITS[x.dtype])
    else:
        LAUNCHES[f"fq_max_pass{sfx}"] += 1
    LAUNCHES[f"fq_quantize{sfx}"] += 1
    return out, state


def fake_quant(x: torch.Tensor, bits: int, percentile: float | None = None) -> torch.Tensor:
    """The fake-quantized ``x`` on the card (no gradient; 1 ≤ bits < 32):
    the same bits as `fake_quant_plain` there, in x's shape, contiguous."""
    return _launch(x, bits, percentile)[0]
