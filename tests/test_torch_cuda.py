"""On a card: each CUDA kernel against its plain version (bf16), and the
SigLIP fast encode against the fp32 canonical tower.  Imports no JAX, so it
runs on a machine without it, where ``tests/conftest.py`` (which imports
JAX) is skipped:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips without a card."""

import dataclasses

import pytest
import torch

from aihab_clip_tpu_torch.ops import block_kernel as bk

ACTS = ["quick_gelu", "gelu_tanh", "gelu_poly"]


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card (bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    w, heads, hidden = 128, 2, 512

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        assert ((out - ref).norm() / ref.norm()).item() <= rel

    x = rnd(3, 80, w)
    p = [1 + rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, 3 * w, scale=w ** -0.5), rnd(3 * w, scale=0.1, dtype=torch.float32),
         rnd(w, w, scale=w ** -0.5), rnd(w, scale=0.1, dtype=torch.float32),
         1 + rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, scale=0.1, dtype=torch.float32),
         rnd(w, hidden, scale=w ** -0.5),
         rnd(hidden, scale=0.1, dtype=torch.float32),
         rnd(hidden, w, scale=hidden ** -0.5),
         rnd(w, scale=0.1, dtype=torch.float32)]
    x2 = x.reshape(-1, w)
    for act in ("none",) + tuple(ACTS):
        for xin in (x2, x2.float()):
            close(bk.ln_gemm(xin, *p[:4], act=act),
                  bk.ln_gemm_plain(xin, *p[:4], act=act), 2e-3)
    for res in (x2, x2.float()):
        for odt in (torch.bfloat16, torch.float32):
            close(bk.gemm_residual(x2, p[4], p[5], res, out_dtype=odt),
                  bk.gemm_residual_plain(x2, p[4], p[5], res, out_dtype=odt),
                  2e-3)
    qkv = rnd(3, 80, 3 * w, scale=2.0)
    for seq_len in (80, 70):
        close(bk.attention(qkv, heads, seq_len)[:, :seq_len],
              bk.attention_plain(qkv, heads, seq_len)[:, :seq_len], 5e-3)
    close(bk.full_block_fused(x, *p, heads),
          bk.full_block_fused_plain(x, *p, heads), 1e-2)
    close(bk.attn_block_fused(x, *p[:6], heads),
          bk.attn_block_fused_plain(x, *p[:6], heads), 1e-2)
    close(bk.mlp_block_fused(x2, *p[6:]), bk.mlp_block_fused_plain(x2, *p[6:]),
          1e-2)


@pytest.mark.gpu
def test_cuda_split_kernels_match_plain():
    """The SigLIP-path kernels against their plain versions on the card
    (bf16): attention at head_dim 72 in the grouped and the packed layout,
    ln_gemm with the q-scale epilogue and with a column-slice weight, and
    K5/K4 at a ragged hidden chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    heads, d, s, hidden = 4, 72, 77, 688
    w = heads * d

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        assert ((out - ref).norm() / ref.norm()).item() <= rel

    qkv = rnd(3, s, 3 * w, scale=2.0)
    for gh in (None, 2):
        for q_scaled in (False, True):
            close(bk.attention(qkv, heads, group_heads=gh, q_scaled=q_scaled),
                  bk.attention_plain(qkv, heads, group_heads=gh,
                                     q_scaled=q_scaled), 5e-3)
    x2 = rnd(3 * s, w)
    ln = (1 + rnd(w, scale=0.1, dtype=torch.float32),
          rnd(w, scale=0.1, dtype=torch.float32))
    wq, bq = rnd(w, 3 * w, scale=w ** -0.5), rnd(3 * w, scale=0.1,
                                                  dtype=torch.float32)
    close(bk.ln_gemm(x2, *ln, wq, bq, eps=1e-6, q_scale=d ** -0.5,
                     q_width=2 * d),
          bk.ln_gemm_plain(x2, *ln, wq, bq, eps=1e-6, q_scale=d ** -0.5,
                           q_width=2 * d), 2e-3)
    wf = rnd(w, hidden, scale=w ** -0.5)
    close(bk.ln_gemm(x2, *ln, wf[:, 344:], bq[:344], act="gelu_tanh"),
          bk.ln_gemm_plain(x2, *ln, wf[:, 344:], bq[:344], act="gelu_tanh"),
          2e-3)
    wo = rnd(w, w, scale=w ** -0.5)
    wg, bg, og = bk.regroup_attn_weights_f(wq, bq, wo, heads, 2)
    bo = rnd(w, scale=0.1, dtype=torch.float32)
    x = x2.reshape(3, s, w)
    close(bk.attn_block_split(x, wg, bg, og, bo, *ln, heads, 2, ln_eps=1e-6),
          bk.attn_block_split_plain(x, wg, bg, og, bo, *ln, heads, 2,
                                    ln_eps=1e-6), 1e-2)
    wp = rnd(hidden, w, scale=hidden ** -0.5)
    for f32_partial in (False, True):
        close(bk.mlp_block_split(x2, *ln, wf, bq[:hidden], wp, bo,
                                 act="gelu_tanh", f32_partial=f32_partial),
              bk.mlp_block_split_plain(x2, *ln, wf, bq[:hidden], wp, bo,
                                       act="gelu_tanh",
                                       f32_partial=f32_partial), 1e-2)


@pytest.mark.gpu
def test_cuda_siglip_fast_encode_matches_fp32_module():
    """A small head_dim-72 SigLIP tower through K5/K4 in bf16 against the
    same tower's canonical module in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.models import SIGLIP_ARCHS, load
    from aihab_clip_tpu_torch.models.fast_siglip import siglip_encode_fast
    from aihab_clip_tpu_torch.models.fast_vit import pack_fastest

    cfg = dataclasses.replace(
        SIGLIP_ARCHS["SigLIP-Tiny"], embed_dim=288, image_resolution=64,
        vision_width=288, vision_heads=4, vision_mlp_dim=688, text_width=288,
        text_heads=4, text_mlp_dim=688)
    bundle = load("random:head72", dtype=torch.bfloat16, device="cuda",
                  random_cfg=cfg, seed=4)
    x = torch.randn(5, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    packed = pack_fastest(bundle.model, cfg, torch.bfloat16)
    bk.reset_launch_counts()
    with torch.inference_mode():
        fast = siglip_encode_fast(bundle.model, x.cuda(), cfg,
                                  packed=packed).float()
        torch.cuda.synchronize()
        counts = bk.launch_counts()
        bundle.model.visual.dtype = torch.float32
        ref = bundle.model.encode_image(x.cuda())
    assert counts["attn_block_split"] == counts["mlp_block_split"] == 2
    assert counts["ln_gemm"] == counts["gemm_residual"] == \
        2 * (1 + packed["mlp_chunks"])
    cos = torch.nn.functional.cosine_similarity(fast, ref, dim=-1)
    assert cos.min().item() >= 0.999
