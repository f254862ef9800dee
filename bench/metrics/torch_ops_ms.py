"""Device ms a request (step) spends in kernels other than the port's own
CUDA kernels: PyTorch's (fake quant, the backward's gathers, the optimizer)."""
from benchlib.readers import other_kernels_ms


def read(ctx):
    return other_kernels_ms(ctx)
