"""The actors' model operations over the window against the card's bf16
peak: every act that returned in the window, one forward step per lane
(``arith.act_flops``), over the window's seconds times 989 TFLOP/s."""


def read(ctx):
    if ctx.acts_lanes == 0:
        return None
    flops = ctx.acts_lanes * ctx.arith.frame_flops(ctx.arch)
    return 100.0 * flops / (ctx.seconds * ctx.peaks.PEAK_FLOPS["bfloat16"])
