"""Mean host time to issue one learner step or super-step (the port's
``learner.step_dispatch`` span) over the window."""


def read(ctx):
    return ctx.tracer.span_mean_ms("learner.step_dispatch")
