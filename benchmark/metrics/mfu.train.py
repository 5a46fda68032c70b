"""mfu.train: the model FLOPs of the fine-tune steps in the window's
untraced rest (``arith.train_step_flops``: the vision forward, the trainable
suffix's and head's backward, the text tower recomputed) over the rest's
wall time, as a share of the card's bf16 peak."""


def read(ctx):
    if ctx.rest is None or ctx.peaks is None:
        return None
    seconds, steps, _ = ctx.rest
    c = ctx.counters
    flops = steps * ctx.arith.train_step_flops(
        ctx.cfg, ctx.traffic["batch"], c["frozen_blocks"], c["prompts"])
    return 100.0 * flops / seconds / ctx.peaks["bf16_flops"]
