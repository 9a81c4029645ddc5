"""The fused LSTM inference kernel (``lstm_step_wgmma``) against its
roofline over the traced stretch: the least time its launches could take
— each the larger of its operations over the bf16 peak and its bytes over
the HBM bandwidth (``arith.lstm_step_kernel``: one step of one layer for
an act's lanes, every input read once and every output written once) —
over the time its launches took.  Nothing when no launch finished inside
the stretch."""

KERNEL = "lstm_step_wgmma"


def read(ctx):
    times = ctx.trace_read.kernel_ns(ctx.ops, KERNEL, ctx.t0_ns, ctx.t1_ns)
    if not times or ctx.lanes_per_act == 0:
        return None
    ops, nbytes = ctx.arith.lstm_step_kernel(ctx.arch, ctx.lanes_per_act)
    least = max(ops / ctx.peaks.PEAK_FLOPS["bfloat16"],
                nbytes / ctx.peaks.HBM_BYTES_S)
    return 100.0 * least * len(times) / (sum(times) / 1e9)
