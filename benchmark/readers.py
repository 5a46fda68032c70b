"""Readings that several per-layer metrics share: each
``metrics/<name>.py`` names one of these as its ``read``, so that a
quantity split by cell (``mfu.classify.so400m``, ``mfu.classify.vitb16``)
is read one way.  A reader returns None where it finds nothing to read."""

from benchmark.trace import kernel_seconds

# the port's bf16 TMA + wgmma GEMM (csrc/block_kernels.cu), behind ln_gemm
# and gemm_residual in K1, K4 and K5
GEMM_KERNELS = ("gemm_kernel",)
# the port's TMA + wgmma flash attention (csrc/block_kernels.cu)
ATTENTION_KERNELS = ("flash_attention_kernel",)


def device_idle_share(ctx):
    """The share of the traced segment A (the card's activity alone) in
    which no kernel, copy or fill ran (1 - busy / window)."""
    p = ctx.profile
    if p is None or p["window_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - p["busy_s"] / p["window_s"])


def classify_mfu(ctx):
    """The model FLOPs of the images classified in the window's untraced
    rest (the vision tower's forward per image; the text head is built once
    at set-up) over the rest's wall time, as a share of the card's bf16
    peak."""
    if ctx.rest is None or ctx.peaks is None:
        return None
    seconds, _, images = ctx.rest
    flops = images * ctx.arith.image_flops(ctx.cfg)
    return 100.0 * flops / seconds / ctx.peaks["bf16_flops"]


def classify_gemm_roofline(ctx):
    """The least time of the vision blocks' GEMMs for the images of the
    traced segment A (``arith.gemm_bound_s``: each GEMM bound by its FLOPs
    or its bytes) over the device time of the kernels that do them."""
    p = ctx.profile
    if p is None or ctx.peaks is None or not p["synced"]:
        return None
    spent = kernel_seconds(p, GEMM_KERNELS)
    if spent <= 0:
        return None
    return 100.0 * ctx.arith.gemm_bound_s(ctx.cfg, p["rows"], ctx.peaks) / spent


def classify_attention_roofline(ctx):
    """The least time of the vision blocks' self-attention for the images
    of the traced segment A (``arith.attention_bound_s``) over the device
    time of the kernel that does it."""
    p = ctx.profile
    if p is None or ctx.peaks is None or not p["synced"]:
        return None
    spent = kernel_seconds(p, ATTENTION_KERNELS)
    if spent <= 0:
        return None
    blocks = ctx.cfg["vision"]["num_hidden_layers"]
    return 100.0 * ctx.arith.attention_bound_s(ctx.cfg, p["rows"], ctx.peaks,
                                               blocks) / spent


def dispatch_host_ms(ctx):
    """The host milliseconds of one call to
    ``ClassifierEngine.classify_dispatch`` (the upload and the launches; it
    does not wait for the result), the mean over the calls in the window's
    untraced rest, from the benchmark's own span."""
    spans = ctx.spans("dispatch")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
