"""Device ms a step spends in operations enqueued inside the program's
``train.optimizer`` span (`repro_torch.train.loop.Trainer`'s update)."""
from benchlib.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.optimizer")
