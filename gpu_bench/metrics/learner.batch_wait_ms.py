"""Mean time the learner waits for its next staged batch (the port's
``learner.batch_wait`` span) over the window."""


def read(ctx):
    return ctx.tracer.span_mean_ms("learner.batch_wait")
