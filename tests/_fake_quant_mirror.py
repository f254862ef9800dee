"""The fake-quant kernels' digit schedule in numpy, for
tests/test_torch_fake_quant.py and tests/test_torch_kernel_emulation.py:
the digits' shifts and widths as ``csrc/fake_quant_kernels.cuh`` defines
them, the magnitude keys, and `select_mirror`, the whole selection."""
import numpy as np

from repro_torch.kernels.fake_quant import digit_passes


def digit_shift(kb: int, p: int) -> int:
    return max(kb - 11 - 10 * p, 0)


def digit_width(kb: int, p: int) -> int:
    return (kb if p == 0 else digit_shift(kb, p - 1)) - digit_shift(kb, p)


def magnitude_keys(x: np.ndarray) -> tuple[np.ndarray, int]:
    """(keys, bits): the magnitudes' bit patterns with the sign cleared, as
    uint32 — float32 input, or bf16 given as its uint16 bits."""
    if x.dtype == np.float32:
        return x.view(np.uint32) & np.uint32(0x7FFFFFFF), 31
    if x.dtype == np.uint16:
        return (x & np.uint16(0x7FFF)).astype(np.uint32), 15
    raise TypeError(f"magnitude_keys takes float32 or bf16 bits (uint16), got {x.dtype}")


def select_mirror(keys: np.ndarray, k: int, kb: int, cap: int) -> tuple[int, list[str]]:
    """(the k-th largest key, what each digit pass read — "x" or "scratch").
    Exact zeros are never counted: the statistic is 0 where k passes the
    nonzero keys. Each pass that reads x copies its keys to a buffer of
    ``cap``; the next pass reads the buffer where they fitted, else x
    again."""
    keys = np.asarray(keys, np.uint32).reshape(-1)
    prefix, rank, from_x, buf, reads = 0, k, True, None, []
    for p in range(digit_passes(kb)):
        shift, width = digit_shift(kb, p), digit_width(kb, p)
        src = keys if from_x else buf
        reads.append("x" if from_x else "scratch")
        mine = src[(src != 0) & ((src >> np.uint32(shift + width)) == prefix)]
        hist = np.bincount((mine >> np.uint32(shift)) & np.uint32((1 << width) - 1), minlength=1 << width)
        if p == 0 and rank > mine.size:
            return 0, reads
        above = np.cumsum(hist[::-1])[::-1] - hist          # keys in bins above each bin
        d = int(np.flatnonzero((above < rank) & (rank <= above + hist))[0])
        prefix, rank = (prefix << width) | d, rank - int(above[d])
        if from_x:
            buf, from_x = mine[:cap], mine.size > cap
    return prefix, reads
