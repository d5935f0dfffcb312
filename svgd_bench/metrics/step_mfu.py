"""The whole step's share, in %, of the card's peak: the step's
operations counted once from the cell's shapes (phi, the median rows'
Gram, the model's gradients; this card's particles) times the steps of the
traced window, over the window's wall times the TF32 peak."""


def read(ctx):
    t = ctx.trace
    return (100.0 * ctx.step_ops * ctx.steps
            / (t.window_s * ctx.flops.PEAK_FLOPS))
