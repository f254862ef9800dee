"""Device ms a request (step) spends in operations enqueued inside the
program's ``kernels.pad_rows`` spans (`repro_torch.kernels.ops._pad_rows`
where it copies a dense operand onto the block grid)."""
from benchlib.spans import device_ms


def read(ctx):
    return device_ms(ctx, "kernels.pad_rows")
