"""Mean time the host replay takes to draw and assemble one batch (the
port's ``buffer.sample_batch`` span) over the window."""


def read(ctx):
    return ctx.tracer.span_mean_ms("buffer.sample_batch")
