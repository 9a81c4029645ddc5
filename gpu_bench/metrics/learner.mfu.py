"""The learner's model operations over the window against the card's
bf16 peak: the window's updates, each worked out from the network's sizes
(``arith``: online and target forwards over the whole sequence, the
backward over the learning steps, no recomputation), over the window's
seconds times 989 TFLOP/s."""


def read(ctx):
    c = ctx.cfg
    if ctx.updates == 0:
        return None
    flops = ctx.updates * ctx.arith.update_flops(
        ctx.arch, c.batch_size, c.seq_len, c.learning_steps)
    return 100.0 * flops / (ctx.seconds * ctx.peaks.PEAK_FLOPS["bfloat16"])
