"""The share of the traced stretch in which nothing ran on the card: no
kernel, copy or set (``torch.profiler``'s device record)."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
