"""The benchmark's own operation and byte counts, from a configuration's
widths, and the table of the card's published peaks.

A FLOP is one multiply or one add (a multiply-add is 2).  Bytes are each
input read once and each output written once, in the dtype the card
computes in (bfloat16, 2 bytes).  Counts are per image (forward) or per
batch of the shapes given.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
BF16 = 2


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by its ``torch.cuda.get_device_name``, or None
    for a card the table does not hold (its shares are then not read)."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def vision_tokens(cfg: dict) -> int:
    v = cfg["vision"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    return n if cfg["family"] == "siglip" else n + 1


def block_gemms(width: int, hidden: int, rows: int):
    """(M, K, N) of a transformer block's four GEMMs: qkv, out-proj, fc,
    proj."""
    return [(rows, width, 3 * width), (rows, width, width),
            (rows, width, hidden), (rows, hidden, width)]


def gemm_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def gemm_bytes(m: int, k: int, n: int) -> float:
    return float(BF16 * (m * k + k * n + m * n))


def attention_flops(batch: int, seq: int, width: int) -> float:
    """QK^T and PV over all heads (2 S^2 D each, times H heads)."""
    return 4.0 * batch * seq * seq * width


def attention_bytes(batch: int, seq: int, width: int) -> float:
    """q, k, v read and the output written once."""
    return float(4 * BF16 * batch * seq * width)


def attention_bwd_flops(batch: int, seq: int, width: int) -> float:
    """dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q: twice the
    forward.  The recomputation of P is not counted."""
    return 2.0 * attention_flops(batch, seq, width)


def attention_bwd_bytes(batch: int, seq: int, width: int, heads: int) -> float:
    """q, k, v, o and dO read, the row statistics (fp32) read, dq, dk, dv
    written."""
    return float(8 * BF16 * batch * seq * width + 4 * batch * heads * seq)


def _block_flops(width: int, hidden: int, seq: int) -> float:
    return (sum(gemm_flops(*g) for g in block_gemms(width, hidden, seq))
            + attention_flops(1, seq, width))


def image_head_flops(cfg: dict) -> float:
    """The head after the blocks, per image: SigLIP's MAP head (the probe's
    q, k and v over the tokens, its attention, out-proj and MLP), CLIP's
    projection of the class token."""
    v = cfg["vision"]
    w, h, s = v["hidden_size"], v["intermediate_size"], vision_tokens(cfg)
    if cfg["family"] == "siglip":
        return (gemm_flops(1, w, w) + 2 * gemm_flops(s, w, w)
                + attention_flops(1, 1, w) * s + gemm_flops(1, w, w)
                + gemm_flops(1, w, h) + gemm_flops(1, h, w))
    return gemm_flops(1, w, cfg["embed_dim"])


def image_flops(cfg: dict, start: int = 0, stop: Optional[int] = None,
                head: bool = True, embed: bool = True) -> float:
    """The vision tower's forward FLOPs per image: the patch embedding, the
    blocks [start, stop) and the head."""
    v = cfg["vision"]
    w, p = v["hidden_size"], v["patch_size"]
    stop = v["num_hidden_layers"] if stop is None else stop
    seq = vision_tokens(cfg)
    n_patch = (v["image_size"] // p) ** 2
    total = (stop - start) * _block_flops(w, v["intermediate_size"], seq)
    if embed:
        total += gemm_flops(n_patch, 3 * p * p, w)
    if head:
        total += image_head_flops(cfg)
    return total


def text_flops(cfg: dict, n_prompts: int) -> float:
    """The text tower's forward over ``n_prompts`` prompts of the full
    context, with its projection."""
    t = cfg["text"]
    ctx, w = t["max_position_embeddings"], t["hidden_size"]
    per = (t["num_hidden_layers"] * _block_flops(w, t["intermediate_size"],
                                                 ctx)
           + gemm_flops(1, w, cfg["embed_dim"]))
    return n_prompts * per


def train_step_flops(cfg: dict, batch: int, n_frozen: int,
                     n_prompts: int) -> float:
    """One fine-tune step: the vision forward, the backward of the blocks
    from ``n_frozen`` on and of the head (twice their forward), the text
    tower's forward (recomputed every step) and the backward that reaches
    its trainable final LayerNorm (through the projection: twice its
    forward)."""
    fwd = batch * image_flops(cfg)
    suffix = batch * image_flops(cfg, start=n_frozen, embed=False)
    text_proj = n_prompts * gemm_flops(1, cfg["text"]["hidden_size"],
                                       cfg["embed_dim"])
    return fwd + 2 * suffix + text_flops(cfg, n_prompts) + 2 * text_proj


def gemm_bound_s(cfg: dict, images: int, peaks: dict,
                 start: int = 0, stop: Optional[int] = None) -> float:
    """The least time of the vision blocks' GEMMs for ``images`` images:
    per GEMM the larger of FLOPs over the bf16 peak and bytes over the
    HBM bandwidth."""
    v = cfg["vision"]
    stop = v["num_hidden_layers"] if stop is None else stop
    rows = images * vision_tokens(cfg)
    per_block = sum(max(gemm_flops(*g) / peaks["bf16_flops"],
                        gemm_bytes(*g) / peaks["hbm_bytes"])
                    for g in block_gemms(v["hidden_size"],
                                         v["intermediate_size"], rows))
    return (stop - start) * per_block


def attention_bound_s(cfg: dict, images: int, peaks: dict, blocks: int,
                      backward_blocks: int = 0) -> float:
    """The least time of the vision blocks' self-attention: ``blocks``
    forwards and ``backward_blocks`` backwards over ``images`` images."""
    v = cfg["vision"]
    s, w = vision_tokens(cfg), v["hidden_size"]
    fwd = max(attention_flops(images, s, w) / peaks["bf16_flops"],
              attention_bytes(images, s, w) / peaks["hbm_bytes"])
    bwd = max(attention_bwd_flops(images, s, w) / peaks["bf16_flops"],
              attention_bwd_bytes(images, s, w, v["num_attention_heads"])
              / peaks["hbm_bytes"])
    return blocks * fwd + backward_blocks * bwd
