"""attention_roofline.train: the least time of the vision blocks'
self-attention in the traced fine-tune steps (every block forward, the
trainable suffix's blocks backward) over the device time of the kernels that
do it."""

from benchmark.trace import kernel_seconds

# the flash attention forward (K5's and K6's, csrc/block_kernels.cu) and
# K6's backward (csrc/fused_attention_bwd.cu)
KERNELS = ("flash_attention_kernel", "attention_bwd_kernel")


def read(ctx):
    p = ctx.profile
    if p is None or ctx.peaks is None or not p["synced"]:
        return None
    spent = kernel_seconds(p, KERNELS)
    if spent <= 0:
        return None
    blocks = ctx.cfg["vision"]["num_hidden_layers"]
    trained = blocks - ctx.counters["frozen_blocks"]
    bound = p["items"] * ctx.arith.attention_bound_s(
        ctx.cfg, ctx.traffic["batch"], ctx.peaks, blocks, trained)
    return 100.0 * bound / spent
