"""Env steps the actors took in the window (every lane of every act that
returned in it) over the window's seconds: the experience the fabric
generates.  A per-layer reading here: the lanes act a few times a second
while the learner's step holds the card, so its runs spread far wider
than an end-to-end bound may be."""


def read(ctx):
    return ctx.acts_lanes / ctx.seconds
