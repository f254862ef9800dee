"""Device ms a step spends in operations enqueued inside the program's
``train.backward`` span (`repro_torch.train.loop.value_and_grad` around
`torch.autograd.grad`), from whichever thread launched them."""
from benchlib.spans import device_ms


def read(ctx):
    return device_ms(ctx, "train.backward")
