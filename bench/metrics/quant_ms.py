"""Device ms a request (step) spends in operations enqueued inside the
program's ``quant.fake_quant`` spans (`repro_torch.core.quant.fake_quant`:
weights and activations)."""
from benchlib.spans import device_ms


def read(ctx):
    return device_ms(ctx, "quant.fake_quant")
