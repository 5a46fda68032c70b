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


@pytest.mark.gpu
def test_cuda_fused_attention_matches_plain():
    """K6 forward and backward against their plain versions on the card
    (bf16): head_dim 72 at S=576 (nine full tiles) and at a ragged S,
    head_dim 64 at another ragged S; the autograd Function and the dispatch
    take the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import attention as att

    g = torch.Generator().manual_seed(2)
    dev = torch.device("cuda")

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        err = ((out - ref).norm() / ref.norm()).item()
        assert err <= rel, err

    for heads, d, s in ((4, 72, 576), (2, 72, 100), (2, 64, 77)):
        q, k, v, dout = (torch.randn(2, s, heads * d, generator=g).to(
            dev, torch.bfloat16) for _ in range(4))
        out, lse = att.fused_attention_fwd(q, k, v, heads)
        close(out, att.fused_attention_plain(q, k, v, heads), 5e-3)
        _, scores = att._probs(q, k, heads, None)
        close(lse, torch.logsumexp(scores, -1), 1e-5)
        grads = att.fused_attention_bwd(q, k, v, out, lse, dout, heads)
        for got, ref in zip(grads, att.fused_attention_bwd_plain(
                q, k, v, dout, heads)):
            close(got, ref, 1e-2)
        only_kv = att.fused_attention_bwd(q, k, v, out, lse, dout, heads,
                                          need_dq=False)
        assert only_kv[0] is None
        assert torch.equal(only_kv[1], grads[1])
        assert torch.equal(only_kv[2], grads[2])

        qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
        att.reset_launch_counts()
        y = att.attention(qa, ka, va, heads, use_fused=True)
        y.backward(dout.transpose(0, 1).contiguous().transpose(0, 1))
        assert att.launch_counts() == {"fused_attention_fwd": 1,
                                       "fused_attention_bwd": 1}
        assert torch.equal(y, out)
        for got, ref in zip((qa.grad, ka.grad, va.grad), grads):
            assert torch.equal(got, ref)
    att.reset_launch_counts()
    x = torch.randn(1, 600, 144, generator=g).to(dev, torch.bfloat16)
    att.attention(x, x, x, 2)
    att.attention(x[:, :500].contiguous(), x[:, :500].contiguous(),
                  x[:, :500].contiguous(), 2)
    att.attention(x.float(), x.float(), x.float(), 2)
    assert att.launch_counts()["fused_attention_fwd"] == 1


@pytest.mark.gpu
def test_cuda_tiny_finetune_runs_the_kernels():
    """One epoch of PEFT on a small head_dim-72 SigLIP tower at S=576 on the
    card: the frozen prefix through K5/K4, the trainable block's attention
    through K6 forward and backward, frozen leaves untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
    from aihab_clip_tpu_torch.models import SIGLIP_ARCHS, load
    from aihab_clip_tpu_torch.ops import attention as att
    from aihab_clip_tpu_torch.train.peft import PEFTConfig, finetune

    cfg = dataclasses.replace(
        SIGLIP_ARCHS["SigLIP-Tiny"], embed_dim=144, image_resolution=384,
        patch_size=16, vision_width=144, vision_layers=3, vision_heads=2,
        vision_mlp_dim=344, text_width=144, text_heads=2, text_mlp_dim=344)
    model = load("random:peft72", dtype=torch.bfloat16, device="cuda",
                 random_cfg=cfg, seed=6).model
    n = 12
    rng = np.random.default_rng(7)
    ds = ImageArrayDataset(
        images=rng.integers(0, 256, (n, 400, 400, 3), dtype=np.uint8),
        labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n, file_names=[""] * n,
        plot_idx=list(range(n)), image_sources=[""] * n)
    weights = torch.nn.functional.normalize(
        torch.randn(144, 20, generator=torch.Generator().manual_seed(8)),
        dim=0).cuda()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bk.reset_launch_counts()
    att.reset_launch_counts()
    out = finetune(model, SplitView(ds, np.arange(8), 4, shuffle=True), None,
                   SplitView(ds, np.arange(8, n), 4),
                   PEFTConfig(resolution=384, num_classes=20, lr=1e-3,
                              epochs=1, rotation=True,
                              compute_dtype=torch.bfloat16, fused_prefix=2),
                   text_weights=weights, unlocked_groups=2, verbose=False,
                   device="cuda")
    torch.cuda.synchronize()
    assert att.launch_counts() == {"fused_attention_fwd": 2,
                                   "fused_attention_bwd": 2}
    # 2 steps x 2 prefix blocks + 1 test batch x 3 blocks
    assert bk.launch_counts()["attn_block_split"] == 7
    assert bk.launch_counts()["mlp_block_split"] == 7
    assert np.isfinite(out["test"]["loss"]) and out["test"]["cm"].sum() == 4
    moved = 0
    for name, trainable in out["mask"].items():
        same = torch.equal(before[name], out["params"][name])
        assert same or trainable, name
        moved += not same
    assert moved > 0


@pytest.mark.gpu
def test_cuda_int8_kernels_match_plain():
    """The int8 kernels against their plain versions on the card: row_quant
    (LN, bf16/fp32, head groups with padding) bit for bit up to the LN's
    reduction order, int8_gemm exactly up to fp32 rounding, K8 with every
    option, K9, K10, and K13 at head_dim 72 with a ragged ``padded_io``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator().manual_seed(3)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        err = ((out - ref).norm() / ref.norm()).item()
        assert err <= rel, err

    def codes(got, want):
        torch.cuda.synchronize()
        d = (got.int() - want.int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5))
        return qm.int8_weight(w8), ws

    m, k, n = 300, 256, 352       # K of q8in: a multiple of 16
    ln = (1 + rnd(k, scale=0.1), rnd(k, scale=0.1))
    for dt in (torch.bfloat16, torch.float32):
        x = rnd(m, k, scale=2.0, dtype=dt)
        for lnk in ({}, dict(ln_scale=ln[0], ln_bias=ln[1])):
            q, s = qm.row_quant(x, *lnk.values())
            qp, sp = qm.row_quant_plain(x, *lnk.values())
            codes(q, qp)
            close(s, sp, 1e-6)
    a = rnd(m, 4 * 72)
    q, s = qm.row_quant(a, group=144, group_pad=160)
    qp, sp = qm.row_quant_plain(a, group=144, group_pad=160)
    assert q.shape == (m, 320) and torch.equal(q, qp) and torch.equal(s, sp)

    w8, ws = weight(k, n)
    b = rnd(n, scale=0.1)
    x8, sx = qm.row_quant(rnd(m, k))
    for act in ("none", "quick_gelu", "gelu_tanh", "gelu_poly"):
        for odt in (torch.bfloat16, torch.float32):
            for res in (None, rnd(m, n, dtype=odt)):
                close(qm.int8_gemm(x8, sx, w8.t(), ws, b, act=act,
                                   residual=res, out_dtype=odt),
                      qm.int8_gemm_plain(x8, sx, w8.t(), ws, b, act=act,
                                         residual=res, out_dtype=odt), 2e-3)
    for dt in (torch.bfloat16, torch.float32):
        x = rnd(m, k, scale=2.0, dtype=dt)
        r = rnd(m, n, dtype=dt)
        for act in ("none", "gelu_tanh", "gelu_poly", "quick_gelu"):
            for opts in ({}, dict(residual=r),
                         dict(ln_scale=ln[0], ln_bias=ln[1]),
                         dict(residual=r, ln_scale=ln[0], ln_bias=ln[1])):
                close(qm.quant_matmul_fused(x, w8, ws, b, act=act, **opts),
                      qm.quant_matmul_fused_plain(x, w8, ws, b, act=act,
                                                  **opts), 2e-3)
        y8, ys = qm.quant_matmul_fused_qout(x, w8, ws, b, *ln, act="gelu_tanh")
        p8, ps = qm.quant_matmul_fused_qout_plain(x, w8, ws, b, *ln,
                                                  act="gelu_tanh")
        codes(y8, p8)
        close(ys, ps, 1e-6)
        w2, s2 = weight(n, k)
        close(qm.quant_matmul_q8in(p8, ps, w2, s2, ln[1], x),
              qm.quant_matmul_q8in_plain(p8, ps, w2, s2, ln[1], x), 2e-3)

    heads, d, groups = 4, 72, 2
    w = heads * d
    wq8, sq = quantize_weight(rnd(w, 3 * w, scale=w ** -0.5))
    wo8, so = quantize_weight(rnd(w, w, scale=w ** -0.5))
    wg, sg, bg, og = qm.regroup_attn_weights(wq8, sq, rnd(3 * w, scale=0.1),
                                             wo8, heads, groups)
    wg, og = qm.int8_attn_weights(wg, og)
    lnw = (1 + rnd(w, scale=0.1), rnd(w, scale=0.1))
    bo = rnd(w, scale=0.1)
    for dt in (torch.bfloat16, torch.float32):
        for s_len, kw in ((77, {}), (96, dict(padded_io=True, seq_len=81))):
            x = rnd(3, s_len, w, dtype=dt)
            qm.reset_launch_counts()
            out = qm.quant_attn_block_split(x, wg, sg, bg, og, so, bo, *lnw,
                                            heads, groups, ln_eps=1e-6, **kw)
            counts = qm.launch_counts()
            assert counts["quant_attn_block_split"] == 1
            assert counts["row_quant"] == counts["int8_gemm"] == 2
            close(out, qm.quant_attn_block_split_plain(
                x, wg, sg, bg, og, so, bo, *lnw, heads, groups, ln_eps=1e-6,
                **kw), 1e-2)


@pytest.mark.gpu
def test_cuda_int8_siglip_encode_matches_plain():
    """A small head_dim-72 SigLIP tower through the int8 kernels against the
    same encode with every kernel plain, and the int8 engine's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from unittest import mock

    from aihab_clip_tpu_torch.models import SIGLIP_ARCHS, load
    from aihab_clip_tpu_torch.models import quant_siglip as qs
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    cfg = dataclasses.replace(
        SIGLIP_ARCHS["SigLIP-Tiny"], embed_dim=288, image_resolution=64,
        vision_width=288, vision_heads=4, vision_mlp_dim=688, text_width=288,
        text_heads=4, text_mlp_dim=688)
    bundle = load("random:head72", dtype=torch.bfloat16, device="cuda",
                  random_cfg=cfg, seed=4)
    x = torch.randn(5, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    qparams = qs.quantize_siglip_params(bundle.model, cfg)
    qm.reset_launch_counts()
    with torch.inference_mode():
        fast = qs.siglip_encode_int8(qparams, bundle.model, x.cuda(),
                                     cfg).float()
        torch.cuda.synchronize()
        counts = qm.launch_counts()
        with mock.patch.multiple(
                qs, quant_matmul_fused=qm.quant_matmul_fused_plain,
                quant_attn_block_split=qm.quant_attn_block_split_plain,
                quant_matmul_fused_qout=qm.quant_matmul_fused_qout_plain,
                quant_matmul_q8in=qm.quant_matmul_q8in_plain):
            plain = qs.siglip_encode_int8(qparams, bundle.model, x.cuda(),
                                          cfg).float()
    assert counts["quant_matmul_fused"] == 1
    for key in ("quant_attn_block_split", "quant_matmul_fused_qout",
                "quant_matmul_q8in"):
        assert counts[key] == cfg.vision_layers, (key, counts)
    cos = torch.nn.functional.cosine_similarity(fast, plain, dim=-1)
    assert cos.min().item() >= 0.995


@pytest.mark.gpu
def test_cuda_vit_int8_kernels_match_plain():
    """The CLIP ViT int8 kernels against their plain versions on the card:
    the residual-first int8_gemm bit for bit (one and two groups, bf16 and
    fp32 out), the attention with P normalised before its cast, K12 at
    head_dim 64 over one head group (S=77, and 81 real tokens in a 96 pad),
    K11, and K14 with one and two MLP chunks and with gelu_poly; each
    wrapper counts one launch.  K12 and K14 are held at
    K13's card tolerance (1e-2 rel L2): at these few rows a handful of int8
    code flips decide the figure (K14 measured 6.4e-3 in bf16 on an H100
    while its attention applied the 1/sum to the output rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator().manual_seed(9)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        err = ((out - ref).norm() / ref.norm()).item()
        assert err <= rel, err

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5))
        return qm.int8_weight(w8), ws

    heads, w, hidden = 2, 128, 512
    h8, hs = qm.row_quant(rnd(300, hidden, scale=2.0), group=hidden // 2)
    w2, s2 = weight(hidden, w)
    b2, y1 = rnd(w, scale=0.1), rnd(300, w)
    for groups in (1, 2):
        a8, sa = (h8, hs) if groups == 2 else qm.row_quant(h8.float())
        for odt in (torch.bfloat16, torch.float32):
            got = qm.int8_gemm(a8, sa, w2.t(), s2, b2, residual=y1,
                               out_dtype=odt, groups=groups,
                               residual_first=True)
            want = qm.int8_gemm_plain(a8, sa, w2.t(), s2, b2, residual=y1,
                                      out_dtype=odt, groups=groups,
                                      residual_first=True)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (groups, odt)

    qkv = rnd(3, 77, 3 * w, dtype=torch.bfloat16)
    for seq_len in (77, 70):
        close(bk.attention(qkv, heads, seq_len, out_dtype=torch.float32,
                           normalize_p=True)[:, :seq_len],
              bk.attention_plain(qkv, heads, seq_len, out_dtype=torch.float32,
                                 normalize_p=True)[:, :seq_len], 5e-3)
    with pytest.raises(ValueError, match="normalize_p"):
        bk.attention(qkv, heads, normalize_p=True)

    wq, sq = weight(w, 3 * w)
    wo, so = weight(w, w)
    w1, s1 = weight(w, hidden)
    ln1 = (1 + rnd(w, scale=0.1), rnd(w, scale=0.1))
    ln2 = (1 + rnd(w, scale=0.1), rnd(w, scale=0.1))
    attn = (wq, sq, rnd(3 * w, scale=0.1), wo, so, rnd(w, scale=0.1), *ln1)
    mlp = (w1, s1, rnd(hidden, scale=0.1), w2, s2, b2)
    for dt in (torch.bfloat16, torch.float32):
        for s_len, kw in ((77, {}), (96, dict(padded_io=True, seq_len=81))):
            x = rnd(3, s_len, w, dtype=dt)
            qm.reset_launch_counts()
            out = qm.quant_attn_block_fused(x, *attn, heads, **kw)
            assert qm.launch_counts()["quant_attn_block_fused"] == 1
            valid = slice(0, kw.get("seq_len", s_len))
            close(out[:, valid], qm.quant_attn_block_fused_plain(
                x, *attn, heads, **kw)[:, valid], 1e-2)
        x2 = rnd(300, w, scale=2.0, dtype=dt)
        close(qm.quant_mlp_block_fused(x2, *mlp, *ln2),
              qm.quant_mlp_block_fused_plain(x2, *mlp, *ln2), 1e-3)
        x = rnd(3, 50, w, dtype=dt)
        for chunks, act in ((1, "quick_gelu"), (2, "quick_gelu"),
                            (1, "gelu_poly")):
            qm.reset_launch_counts()
            out = qm.quant_full_block_fused(x, *attn, *mlp, *ln2, heads,
                                            mlp_chunks=chunks, act=act)
            counts = qm.launch_counts()
            assert counts["quant_full_block_fused"] == 1
            # LN1, the attention row and LN2; the hidden row requantizes in
            # its c_fc GEMM
            assert counts["row_quant"] == 3 and counts["int8_gemm"] == 4
            close(out, qm.quant_full_block_fused_plain(
                x, *attn, *mlp, *ln2, heads, mlp_chunks=chunks, act=act),
                1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("unlocked,prefix_quant", [(1, False), (11, False),
                                                   (11, True)])
def test_cuda_vit_b16_finetune_default_prefix(unlocked, prefix_quant):
    """A ViT-B/16 fine-tune with the default ``fused_prefix`` (-1) on the
    card, the configuration that once crashed: the frozen prefix is
    L + 1 - unlocked_groups blocks (12 at unlocked_groups 1, 2 at 11) and
    runs through K1 (or K14 with ``prefix_quant``) in every step; frozen
    leaves stay untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.train.peft import PEFTConfig, finetune

    model = load("random:ViT-B/16", device="cuda", seed=10).model
    n = 12
    rng = np.random.default_rng(11)
    ds = ImageArrayDataset(
        images=rng.integers(0, 256, (n, 240, 240, 3), dtype=np.uint8),
        labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n, file_names=[""] * n,
        plot_idx=list(range(n)), image_sources=[""] * n)
    weights = torch.nn.functional.normalize(
        torch.randn(512, 20, generator=torch.Generator().manual_seed(12)),
        dim=0).cuda()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bk.reset_launch_counts()
    qm.reset_launch_counts()
    out = finetune(model, SplitView(ds, np.arange(8), 4, shuffle=True), None,
                   SplitView(ds, np.arange(8, n), 4),
                   PEFTConfig(resolution=224, num_classes=20, lr=1e-3,
                              epochs=1, compute_dtype=torch.bfloat16,
                              prefix_quant=prefix_quant),
                   text_weights=weights, unlocked_groups=unlocked,
                   verbose=False, device="cuda")
    torch.cuda.synchronize()
    prefix = 12 + 1 - unlocked
    # 2 steps of the prefix, then 1 test batch through the 12 K1 blocks
    k14 = qm.launch_counts()["quant_full_block_fused"]
    assert k14 == (2 * prefix if prefix_quant else 0)
    assert bk.launch_counts()["full_block_fused"] == \
        (0 if prefix_quant else 2 * prefix) + 12
    assert np.isfinite(out["test"]["loss"]) and out["test"]["cm"].sum() == 4
    moved = 0
    for name, trainable in out["mask"].items():
        same = torch.equal(before[name], out["params"][name])
        assert same or trainable, name
        moved += not same
    assert moved > 0


@pytest.mark.gpu
def test_cuda_convnext_kernels_match_plain():
    """K7 (one and two hidden chunks) and K15 against their plain versions
    on the card for each gelu_poly form (the forms past sig5 through
    ``act_pass`` after the GEMM), held on the branch out - residual, which
    the residual would otherwise dominate: K7 at 1e-2 rel L2 (K3 and K4's
    gate), K15 at 1e-3 (K11's); each wrapper counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os

    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator().manual_seed(13)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def branch(out, ref, res, rel):
        torch.cuda.synchronize()
        out, ref = out.float() - res.float(), ref.float() - res.float()
        assert torch.isfinite(out).all()
        err = ((out - ref).norm() / ref.norm()).item()
        assert err <= rel, err

    m, c = 300, 256
    y, res = rnd(m, c, scale=2.0, dtype=torch.bfloat16), rnd(
        m, c, dtype=torch.bfloat16)
    ln = (1 + rnd(c, scale=0.1), rnd(c, scale=0.1))
    w1, w2 = rnd(c, 4 * c, scale=c ** -0.5), rnd(4 * c, c,
                                                 scale=(4 * c) ** -0.5)
    b1, b2, gamma = rnd(4 * c, scale=0.1), rnd(c, scale=0.1), rnd(c,
                                                                scale=0.3)
    args = (y, res, *ln, w1.bfloat16(), b1, w2.bfloat16(), b2, gamma)
    old = os.environ.get("AIHAB_ERF_IMPL")
    try:
        for form in ("sig5", "sig", "rational", "cheb"):
            os.environ["AIHAB_ERF_IMPL"] = form
            for n_chunks in (1, 2):
                bk.reset_launch_counts()
                out = bk.convnext_mlp_block(*args, n_chunks=n_chunks)
                assert bk.launch_counts()["convnext_mlp_block"] == 1
                assert bk.launch_counts()["ln_gemm"] == n_chunks
                branch(out, bk.convnext_mlp_block_plain(
                    *args, n_chunks=n_chunks), res, 1e-2)
    finally:
        if old is None:
            os.environ.pop("AIHAB_ERF_IMPL", None)
        else:
            os.environ["AIHAB_ERF_IMPL"] = old
    (w1_8, s1), (w2_8, s2) = quantize_weight(w1), quantize_weight(w2)
    qargs = (*ln, qm.int8_weight(w1_8), s1, b1, qm.int8_weight(w2_8), s2, b2,
             gamma)
    try:
        for form, dt in (("sig5", torch.bfloat16), ("sig5", torch.float32),
                         ("sig", torch.bfloat16), ("rational", torch.float32),
                         ("cheb", torch.bfloat16)):
            os.environ["AIHAB_ERF_IMPL"] = form
            qm.reset_launch_counts()
            out = qm.quant_convnext_mlp_block(y.to(dt), res.to(dt), *qargs)
            counts = qm.launch_counts()
            assert counts["quant_convnext_mlp_block"] == 1
            # sig5 requantizes the hidden row in fc1's epilogue; the other
            # forms run fp32 fc1, act_pass and row_quant
            assert counts["int8_gemm"] == 2
            assert counts["row_quant"] == (1 if form == "sig5" else 2)
            branch(out, qm.quant_convnext_mlp_block_plain(
                y.to(dt), res.to(dt), *qargs), res, 1e-3)
    finally:
        if old is None:
            os.environ.pop("AIHAB_ERF_IMPL", None)
        else:
            os.environ["AIHAB_ERF_IMPL"] = old


@pytest.mark.gpu
def test_cuda_convnext_base_w_engines():
    """``random:convnext_base_w`` served at full size on the card: the bf16
    engine runs 36 K7 per batch, the int8 engine 36 K15 and no K7; both
    give probabilities, and their features agree at cosine >= 0.99."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.serving import ClassifierEngine

    imgs = np.random.default_rng(14).integers(0, 256, (8, 256, 256, 3),
                                              dtype=np.uint8)
    probs = {}
    for quantize in ("none", "int8"):
        engine = ClassifierEngine(model="random:convnext_base_w",
                                  batch_size=8, buckets=1, flat=True,
                                  quantize=quantize, verbose=False)
        bk.reset_launch_counts()
        qm.reset_launch_counts()
        probs[quantize] = engine.classify_batch(imgs)
        k7 = bk.launch_counts()["convnext_mlp_block"]
        k15 = qm.launch_counts()["quant_convnext_mlp_block"]
        assert (k7, k15) == ((36, 0) if quantize == "none" else (0, 36))
        assert probs[quantize].shape == (8, 20)
        assert np.isfinite(probs[quantize]).all()
        del engine
        torch.cuda.empty_cache()
    assert np.abs(probs["none"] - probs["int8"]).max() <= 0.2


@pytest.mark.gpu
def test_cuda_convnext_finetune_default_prefix():
    """A ConvNeXt fine-tune with the default ``fused_prefix`` on the card (a
    narrow base_w: widths 32-256, depths (3, 3, 27, 3)): the frozen prefix
    is L + 1 - unlocked_groups = 26 blocks through K7 in every step, the
    test batch through all 36; frozen leaves stay untouched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import ImageArrayDataset, SplitView
    from aihab_clip_tpu_torch.models import CLIP_ARCHS, load
    from aihab_clip_tpu_torch.train.peft import PEFTConfig, finetune

    cfg = dataclasses.replace(CLIP_ARCHS["convnext_base_w"], vision_width=32,
                              embed_dim=64, transformer_width=64,
                              transformer_heads=1, transformer_layers=2)
    model = load("random:base_w-narrow", device="cuda", random_cfg=cfg,
                 seed=15).model
    n = 12
    rng = np.random.default_rng(16)
    ds = ImageArrayDataset(
        images=rng.integers(0, 256, (n, 272, 272, 3), dtype=np.uint8),
        labels=rng.integers(0, 20, n), l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n, file_names=[""] * n,
        plot_idx=list(range(n)), image_sources=[""] * n)
    weights = torch.nn.functional.normalize(
        torch.randn(64, 20, generator=torch.Generator().manual_seed(17)),
        dim=0).cuda()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bk.reset_launch_counts()
    out = finetune(model, SplitView(ds, np.arange(8), 4, shuffle=True), None,
                   SplitView(ds, np.arange(8, n), 4),
                   PEFTConfig(resolution=256, num_classes=20, lr=1e-3,
                              epochs=1, rotation=True,
                              compute_dtype=torch.bfloat16),
                   text_weights=weights, unlocked_groups=11, verbose=False,
                   device="cuda")
    torch.cuda.synchronize()
    # 2 steps x 26 prefix blocks + 1 test batch x 36 blocks
    assert bk.launch_counts()["convnext_mlp_block"] == 2 * 26 + 36
    assert np.isfinite(out["test"]["loss"]) and out["test"]["cm"].sum() == 4
    moved = 0
    for name, trainable in out["mask"].items():
        same = torch.equal(before[name], out["params"][name])
        assert same or trainable, name
        moved += not same
    assert moved > 0


@pytest.mark.gpu
def test_cuda_fused_linear_matches_plain():
    """K16 on the card: ``ln_matmul`` at every kernel activation (eps 1e-5
    and 1e-6) and ``matmul_residual`` (bf16 and fp32 residual) against their
    plain versions, a ragged N padded and sliced; exact gelu launches
    nothing; fp32 operands and a ragged K raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import fused_linear as fl

    g = torch.Generator().manual_seed(20)
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def close(out, ref, rel=2e-3):
        torch.cuda.synchronize()
        assert out.shape == ref.shape and out.dtype == ref.dtype
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        assert ((out - ref).norm() / ref.norm()).item() <= rel

    x = rnd(197, 128)
    ls, lb = 1 + rnd(128, scale=0.1, dtype=torch.float32), \
        rnd(128, scale=0.1, dtype=torch.float32)
    fl.reset_launch_counts()
    for n in (384, 100):
        w, b = rnd(128, n, scale=128 ** -0.5), rnd(n, scale=0.1,
                                                  dtype=torch.float32)
        for act in (None, "quick_gelu", "gelu_tanh", "gelu_poly"):
            for eps in (1e-5, 1e-6):
                close(fl.ln_matmul(x, ls, lb, w, b, act, eps),
                      fl.ln_matmul_plain(x, ls, lb, w, b, act, eps))
        h = rnd(197, 128, scale=2.0)
        for res in (rnd(197, n), rnd(197, n, dtype=torch.float32)):
            close(fl.matmul_residual(h, w, b, res),
                  fl.matmul_residual_plain(h, w, b, res))
    assert fl.launch_counts() == {"ln_matmul": 16, "matmul_residual": 4}
    out = fl.ln_matmul(x, ls, lb, w, b, "gelu")
    assert fl.launch_counts()["ln_matmul"] == 16
    assert torch.equal(out, fl._ln_matmul_xla(x, ls, lb, w, b, "gelu"))
    with pytest.raises(TypeError, match="bf16"):
        fl.ln_matmul(x.float(), ls, lb, w.float(), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        fl.matmul_residual(rnd(4, 12), rnd(12, 8), b[:8], rnd(4, 8))


@pytest.mark.gpu
def test_cuda_normalize_u8_is_bit_exact():
    """K18 on the card equals its plain version bit for bit, in bf16 and
    fp32, with a ragged tail (17 x 13 x 3 and 5 x 5 x 3 are no multiple of
    its 48-byte unit), and past one wave of blocks (180 x 224^2 x 3: more
    units than the grid's threads take in one step);
    ``normalize_u8(use_pallas=True)`` launches it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import pallas_preprocess as pp

    g = torch.Generator().manual_seed(21)
    pp.reset_launch_counts()
    shapes = ((180, 224, 224, 3), (1, 5, 5, 3), (2, 224, 224, 3),
              (1, 17, 13, 3))
    for shape in shapes:
        u8 = torch.randint(0, 256, shape, generator=g,
                           dtype=torch.uint8).cuda()
        for dt in (torch.bfloat16, torch.float32):
            out = pp.normalize_u8_pallas(u8, dtype=dt)
            torch.cuda.synchronize()
            assert torch.equal(out, pp.normalize_u8_pallas_plain(u8,
                                                                 dtype=dt))
    assert torch.equal(pp.normalize_u8(u8, use_pallas=True),
                       pp.normalize_u8_pallas_plain(u8))
    assert pp.launch_counts() == {"normalize_u8_pallas": 2 * len(shapes) + 1}


@pytest.mark.gpu
def test_cuda_mlp_block_train_matches_plain():
    """K17 on the card: the forward's (y, h_pre) and the backward's (dx,
    dh_pre, dln) against their plain versions, and the autograd Function's
    seven gradients against the plain Function's; one launch each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(22)
    dev = torch.device("cuda")
    m, w, hidden = 300, 128, 512

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    args = [rnd(m, w), 1 + rnd(w, scale=0.1, dtype=torch.float32),
            rnd(w, scale=0.1, dtype=torch.float32),
            rnd(w, hidden, scale=w ** -0.5),
            rnd(hidden, scale=0.1, dtype=torch.float32),
            rnd(hidden, w, scale=hidden ** -0.5),
            rnd(w, scale=0.1, dtype=torch.float32)]

    def close(out, ref, rel):
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all()
        assert ((out - ref).norm() / ref.norm()).item() <= rel

    bk.reset_launch_counts()
    fwd, fwd_ref = bk.mlp_block_train_fwd(*args), \
        bk.mlp_block_train_fwd_plain(*args)
    dy = rnd(m, w)
    bwd = bk.mlp_block_train_bwd(args[0], fwd_ref[1], dy, args[1], args[3],
                                 args[5])
    bwd_ref = bk.mlp_block_train_bwd_plain(args[0], fwd_ref[1], dy, args[1],
                                           args[3], args[5])
    torch.cuda.synchronize()
    for out, ref in zip(fwd + bwd, fwd_ref + bwd_ref):
        close(out, ref, 5e-3)
    grads = []
    for fn in (bk.mlp_block_train, bk.mlp_block_train_plain):
        ins = [a.detach().clone().requires_grad_() for a in args]
        (fn(*ins).float() * dy.float()).sum().backward()
        grads.append([t.grad for t in ins])
    for got, ref in zip(*grads):
        assert got.dtype == ref.dtype
        close(got, ref, 1e-2)
    assert bk.launch_counts()["mlp_block_train_fwd"] == 2
    assert bk.launch_counts()["mlp_block_train_bwd"] == 2


@pytest.mark.gpu
def test_cuda_vit_paths_run_the_new_kernels():
    """Path (a) at a small size: uint8 -> K18 -> ``vit_encode_fast`` (2 + 2
    K16 per block) against the same encode with every kernel plain, and the
    opt-out block stack of a gelu tower (K2 + plain exact-gelu ``ln_matmul``
    + K16 ``matmul_residual``); path (b): ``vit_encode_train`` with one K17
    forward and backward per block, its gradients against the plain K17."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import os
    from unittest import mock

    from aihab_clip_tpu_torch.models import CLIP_ARCHS, fast_vit, load
    from aihab_clip_tpu_torch.ops import fused_linear as fl
    from aihab_clip_tpu_torch.ops import pallas_preprocess as pp

    cfg = dataclasses.replace(CLIP_ARCHS["ViT-B/16"], image_resolution=64,
                              vision_layers=2)
    model = load("random:vitb16-small", device="cuda", random_cfg=cfg,
                 seed=23).model
    packed = fast_vit.pack_fastest(model, cfg, torch.bfloat16)
    u8 = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(24)).cuda()
    fl.reset_launch_counts()
    pp.reset_launch_counts()
    with torch.no_grad():
        x = pp.normalize_u8(u8, use_pallas=True)
        feats = fast_vit.vit_encode_fast(packed, x, cfg, project=True)[1]
        with mock.patch.multiple(fast_vit, ln_matmul=fl.ln_matmul_plain,
                                 matmul_residual=fl.matmul_residual_plain):
            plain = fast_vit.vit_encode_fast(packed, x, cfg,
                                             project=True)[1]
    assert fl.launch_counts() == {"ln_matmul": 4, "matmul_residual": 4}
    assert pp.launch_counts() == {"normalize_u8_pallas": 1}
    cos = torch.nn.functional.cosine_similarity(feats.float(), plain.float())
    assert cos.min().item() >= 0.999

    gcfg = dataclasses.replace(cfg, act="gelu")
    bk.reset_launch_counts()
    fl.reset_launch_counts()
    with mock.patch.dict(os.environ, {"AIHAB_NO_GELU_POLY": "1"}), \
            torch.no_grad():
        off = fast_vit.vit_encode_block_fused(packed, x, gcfg)
    assert torch.isfinite(off.float()).all()
    assert bk.launch_counts()["attn_block_fused"] == 2
    assert bk.launch_counts()["full_block_fused"] == 0
    assert fl.launch_counts() == {"ln_matmul": 0, "matmul_residual": 2}

    grads = []
    for fn in (bk.mlp_block_train, bk.mlp_block_train_plain):
        bk.reset_launch_counts()
        model.zero_grad(set_to_none=True)
        with mock.patch.object(fast_vit, "mlp_block_train", fn):
            _, f = fast_vit.vit_encode_train(model, x, cfg, project=True)
        f.float().square().sum().backward()
        grads.append(torch.cat([p.grad.float().flatten() for p in
                                model.visual.parameters()]))
        counts = bk.launch_counts()
        n = 2 if fn is bk.mlp_block_train else 0
        assert counts["mlp_block_train_fwd"] == counts[
            "mlp_block_train_bwd"] == n
    cos = torch.nn.functional.cosine_similarity(*grads, dim=0).item()
    assert cos >= 0.999


# chip_smoke.py's tolerances: (rel L2, max|d| / max|ref|)
TOL_KERNEL, TOL_ATTENTION = (2e-3, 0.02), (5e-3, 0.02)


def _assert_close(out, ref, tol, base=None):
    """out against ref (both minus base, when given) within tol."""
    torch.cuda.synchronize()
    out, ref = out.float(), ref.float()
    assert torch.isfinite(out).all()
    if base is not None:
        out, ref = out - base.float(), ref - base.float()
    d = (out - ref).abs()
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel <= tol[0], rel
    assert d.max().item() <= tol[1] * ref.abs().max().item()


# every instance of the TMA + wgmma GEMM (csrc/block_kernels.cu gemm_kernel)
# at ragged edges: M off the 128-row tile, N = 8 x odd, K off the 64-deep
# k-step, column slices of wider weights (ldw != N)
GEMM_CASES = [
    # (name, M, K, N, options)
    ("ln bf16 none", 200, 136, 200, dict(kind="ln")),
    ("ln fp32 A", 77, 128, 520, dict(kind="ln", x_f32=True)),
    ("ln quick_gelu", 300, 768, 3 * 8 * 17, dict(kind="ln", act="quick_gelu")),
    ("ln gelu_tanh", 131, 1152, 264, dict(kind="ln", act="gelu_tanh")),
    ("ln gelu_poly", 260, 128, 512, dict(kind="ln", act="gelu_poly",
                                         eps=1e-6)),
    ("ln gelu_poly act_pass", 70, 128, 136, dict(kind="ln", act="gelu_poly",
                                                 erf="rational")),
    ("ln fp32 Y", 129, 64, 104, dict(kind="ln", y_f32=True)),
    ("ln q-scale groups", 197, 192, 3 * 2 * 96, dict(kind="ln", q_width=96)),
    ("ln column slice", 150, 256, 2152 // 8 * 8, dict(kind="ln", slice=True)),
    ("res bf16", 200, 136, 200, dict(kind="res")),
    ("res fp32 R, fp32 Y", 333, 2152, 1152, dict(kind="res", r_f32=True,
                                                 y_f32=True)),
    ("res fp32 R, bf16 Y", 12608 // 8, 3072, 768, dict(kind="res",
                                                      r_f32=True)),
    ("res gamma, no bias", 262, 512, 128, dict(kind="res", gamma=True,
                                               bias=False)),
    ("res column slice", 99, 72, 88, dict(kind="res", slice=True)),
    ("res K = 128 (ConvNeXt stage 0)", 4096 + 40, 128, 512,
     dict(kind="res", gamma=True)),
    ("train EPI_PRE + EPI_DGELU", 3152 // 4 + 3, 768, 3072, dict(kind="train")),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GEMM_CASES, ids=[c[0] for c in GEMM_CASES])
def test_cuda_wgmma_gemm_matches_plain(case, monkeypatch):
    """Each instance of the TMA + wgmma GEMM against its plain version:
    ln_gemm (bf16 or fp32 A, bf16 or fp32 Y, each act, the q-scale of head
    groups), gemm_residual (bf16 or fp32 residual and output, gamma, no
    bias), K17's EPI_PRE forward and EPI_DGELU backward, at ragged M, N and
    K and on column slices of wider weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name, m, k, n, opt = case
    g = torch.Generator().manual_seed(len(name))
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    def weight(rows, cols):
        if opt.get("slice"):  # columns 8.. of a matrix 24 wider
            return rnd(rows, cols + 24, scale=rows ** -0.5)[:, 8:8 + cols]
        return rnd(rows, cols, scale=rows ** -0.5)

    if opt.get("erf"):
        monkeypatch.setenv("AIHAB_ERF_IMPL", opt["erf"])
    if opt["kind"] == "ln":
        x = rnd(m, k, dtype=torch.float32 if opt.get("x_f32") else
                torch.bfloat16)
        args = (x, 1 + rnd(k, scale=0.1, dtype=torch.float32),
                rnd(k, scale=0.1, dtype=torch.float32), weight(k, n),
                rnd(n, scale=0.1, dtype=torch.float32))
        kw = dict(act=opt.get("act", "none"), eps=opt.get("eps", 1e-5))
        if opt.get("q_width"):
            kw.update(q_scale=0.125, q_width=opt["q_width"])
        got, ref = bk.ln_gemm(*args, **kw), bk.ln_gemm_plain(*args, **kw)
        if opt.get("y_f32"):  # the fp32-output instance, as act_pass reads it
            got = bk.gemm_residual(bk._ln_f32(x, *args[1:3]).to(
                torch.bfloat16), args[3], args[4], torch.zeros(
                m, n, device=dev), out_dtype=torch.float32)
            ref = bk.gemm_residual_plain(bk._ln_f32(x, *args[1:3]).to(
                torch.bfloat16), args[3], args[4], torch.zeros(
                m, n, device=dev), out_dtype=torch.float32)
        _assert_close(got, ref, TOL_KERNEL)
    elif opt["kind"] == "res":
        a = rnd(m, k)
        w = weight(k, n)
        bias = rnd(n, scale=0.1, dtype=torch.float32) if opt.get(
            "bias", True) else None
        res = rnd(m, n, dtype=torch.float32 if opt.get("r_f32") else
                  torch.bfloat16)
        gamma = rnd(n, scale=0.1, dtype=torch.float32) if opt.get(
            "gamma") else None
        odt = torch.float32 if opt.get("y_f32") else torch.bfloat16
        got = bk.gemm_residual(a, w, bias, res, out_dtype=odt, gamma=gamma)
        ref = bk.gemm_residual_plain(a, w, bias, res, out_dtype=odt,
                                     gamma=gamma)
        # the branch out - residual, which the residual would dominate
        _assert_close(got, ref, TOL_KERNEL, base=res)
    else:  # K17: EPI_PRE stores h_pre beside h; EPI_DGELU reads it back
        w, hidden = k, n
        x = rnd(m, w)
        p = (1 + rnd(w, scale=0.1, dtype=torch.float32),
             rnd(w, scale=0.1, dtype=torch.float32), weight(w, hidden),
             rnd(hidden, scale=0.1, dtype=torch.float32),
             rnd(hidden, w, scale=hidden ** -0.5),
             rnd(w, scale=0.1, dtype=torch.float32))
        y, h_pre = bk.mlp_block_train_fwd(x, *p)
        y_ref, h_pre_ref = bk.mlp_block_train_fwd_plain(x, *p)
        _assert_close(y, y_ref, TOL_KERNEL, base=x)
        _assert_close(h_pre, h_pre_ref, TOL_KERNEL)
        dy = rnd(m, w)
        for got, ref in zip(
                bk.mlp_block_train_bwd(x, h_pre_ref, dy, p[0], p[2], p[4]),
                bk.mlp_block_train_bwd_plain(x, h_pre_ref, dy, p[0], p[2],
                                             p[4])):
            _assert_close(got, ref, TOL_KERNEL)


# the TMA + wgmma flash attention (flash_attention_kernel) at both head
# widths, full and ragged S, masked keys, grouped and separate layouts
FLASH_CASES = [
    # (B, S, heads, head_dim, group_heads, seq_len)
    (2, 197, 12, 64, None, None),
    (2, 197, 12, 64, None, 150),
    (2, 576, 16, 72, 2, None),
    (1, 577, 16, 72, 2, 500),
    (2, 577, 4, 64, 4, None),
    (1, 576, 16, 72, None, 576),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,heads,d,group_heads,seq_len", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(b, s, heads, d, group_heads,
                                            seq_len):
    """The flash attention against the plain versions: the grouped qkv
    layout of K1, K2 and K5 (bk.attention, keys >= seq_len masked), and K6's
    separate q, k, v with the row log-sum-exp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import attention as att

    g = torch.Generator().manual_seed(s + d)
    dev = torch.device("cuda")
    qkv = (torch.randn(b, s, 3 * heads * d, generator=g) * 2).to(
        dev, torch.bfloat16)
    bk.reset_launch_counts()
    got = bk.attention(qkv, heads, seq_len, group_heads=group_heads)
    assert bk.launch_counts()["attention"] == 1
    _assert_close(got, bk.attention_plain(qkv, heads, seq_len,
                                          group_heads=group_heads),
                  TOL_ATTENTION)
    q, k, v = (torch.randn(b, s, heads * d, generator=g).to(
        dev, torch.bfloat16) for _ in range(3))
    out, lse = att.fused_attention_fwd(q, k, v, heads)
    _assert_close(out, att.fused_attention_plain(q, k, v, heads),
                  TOL_ATTENTION)
    _, scores = att._probs(q, k, heads, None)
    _assert_close(lse, torch.logsumexp(scores, -1), (1e-5, 1e-5))


# K6b (csrc/fused_attention_bwd.cu, TMA + wgmma) at both head widths, at
# S of one ragged tile, nine full tiles and nine plus one row
BWD_CASES = [(d, s) for d in (64, 72) for s in (197, 576, 577)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,s", BWD_CASES)
def test_cuda_fused_attention_bwd_wgmma(d, s):
    """The backward kernels against ``fused_attention_bwd_plain(out=)`` (the
    kernels' row term, rowsum(dO * O)) within the attention tolerance; the
    need_dq / need_dkdv subsets equal the full call's outputs; two runs are
    bit-identical (each output is written by one block, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import attention as att

    heads = 4
    g = torch.Generator().manual_seed(d * 1000 + s)
    q, k, v, dout = (torch.randn(2, s, heads * d, generator=g).to(
        "cuda", torch.bfloat16) for _ in range(4))
    out, lse = att.fused_attention_fwd(q, k, v, heads)
    att.reset_launch_counts()
    grads = att.fused_attention_bwd(q, k, v, out, lse, dout, heads)
    assert att.launch_counts()["fused_attention_bwd"] == 1
    refs = att.fused_attention_bwd_plain(q, k, v, dout, heads, out=out)
    for got, ref in zip(grads, refs):
        _assert_close(got, ref, TOL_ATTENTION)
    again = att.fused_attention_bwd(q, k, v, out, lse, dout, heads)
    only_q = att.fused_attention_bwd(q, k, v, out, lse, dout, heads,
                                     need_dkdv=False)
    only_kv = att.fused_attention_bwd(q, k, v, out, lse, dout, heads,
                                      need_dq=False)
    torch.cuda.synchronize()
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    assert only_q[1] is None and only_q[2] is None
    assert torch.equal(only_q[0], grads[0])
    assert only_kv[0] is None
    assert torch.equal(only_kv[1], grads[1])
    assert torch.equal(only_kv[2], grads[2])


# the flash kernel's fp32 output (K13's grouped attention): q pre-scaled,
# keys at or past seq_len masked
FLASH_F32_CASES = [
    # (B, S, heads, head_dim, group_heads, seq_len)
    (2, 576, 16, 72, 2, None),
    (1, 592, 16, 72, 2, 577),
    (2, 197, 12, 64, None, 150),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,heads,d,group_heads,seq_len", FLASH_F32_CASES)
def test_cuda_flash_attention_fp32_out(b, s, heads, d, group_heads, seq_len):
    """``attention(out_dtype=fp32, q_scaled=True)`` (the flash kernel's fp32
    store) against the plain grouped attention with the same one-pass
    rounding (P cast unnormalised, 1/sum on the rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(s * d)
    qkv = (torch.randn(b, s, 3 * heads * d, generator=g) * 0.5).to(
        "cuda", torch.bfloat16)
    bk.reset_launch_counts()
    got = bk.attention(qkv, heads, seq_len, group_heads=group_heads,
                       q_scaled=True, out_dtype=torch.float32)
    assert bk.launch_counts()["attention"] == 1 and got.dtype == torch.float32
    ref = bk.attention_plain(qkv, heads, seq_len, group_heads=group_heads,
                             q_scaled=True, out_dtype=torch.float32)
    _assert_close(got, ref, TOL_ATTENTION)


# the TMA + wgmma int8 GEMM (csrc/quant_kernels.cu int8_gemm_kernel) in every
# mode at ragged M (off the 128-row tile) and N (8 x odd)
INT8_CASES = [
    # (name, M, K, N, options)
    ("none bf16", 300, 256, 352, {}),
    ("none fp32, K ragged by 16", 129, 272, 136, dict(out=torch.float32)),
    ("bf16 residual", 300, 1152, 344, dict(res=torch.bfloat16)),
    ("fp32 residual, fp32 out", 77, 768, 200,
     dict(res=torch.float32, out=torch.float32)),
    ("q-scale", 197, 256, 3 * 2 * 96, dict(q_width=96)),
    ("gamma + bf16 residual", 260, 512, 128,
     dict(gamma=True, res=torch.bfloat16)),
    ("2 groups of 144 padded to 160", 300, 320, 288,
     dict(groups=2, res=torch.bfloat16)),
    ("8 groups of 144 padded to 160, fp32", 130, 1280, 1152,
     dict(groups=8, res=torch.float32, out=torch.float32)),
    ("residual-first", 197, 768, 264, dict(res_first=True)),
    ("residual-first, 2 groups of 384", 150, 768, 136,
     dict(res_first=True, groups=2, out=torch.float32)),
    ("quick_gelu", 300, 256, 352, dict(act="quick_gelu")),
    ("gelu_tanh fp32", 131, 1152, 264, dict(act="gelu_tanh",
                                            out=torch.float32)),
    ("gelu_poly + residual", 70, 512, 136,
     dict(act="gelu_poly", res=torch.bfloat16)),
    ("gelu_poly rational (act_pass)", 70, 128, 136,
     dict(act="gelu_poly", erf="rational", out=torch.float32)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_CASES, ids=[c[0] for c in INT8_CASES])
def test_cuda_int8_gemm_wgmma(case, monkeypatch):
    """Each mode of the int8 GEMM against ``int8_gemm_plain``: bit for bit
    where the epilogue has no activation (the int32 sums are exact and every
    fp32 step is the plain version's, in its order); with an activation
    within the fp32 ulps of its transcendental (bf16: one rounding step);
    and every launch deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    name, m, k, n, opt = case
    g = torch.Generator().manual_seed(len(name) + m)
    dev = torch.device("cuda")
    if opt.get("erf"):
        monkeypatch.setenv("AIHAB_ERF_IMPL", opt["erf"])
    groups = opt.get("groups", 1)
    a8, wt = (torch.randint(-127, 128, shape, generator=g,
                            dtype=torch.int8).to(dev)
              for shape in ((m, k), (n, k)))
    sa = (torch.rand(m, groups, generator=g) * 0.02 + 1e-3).to(dev)
    ws = (torch.rand(n, generator=g) * 0.02 + 1e-3).to(dev)
    bias = (torch.randn(n, generator=g) * 0.1).to(dev)
    kw = dict(act=opt.get("act", "none"), out_dtype=opt.get("out",
                                                            torch.bfloat16),
              groups=groups, residual_first=opt.get("res_first", False))
    if opt.get("res") is not None or kw["residual_first"]:
        rdt = torch.float32 if kw["residual_first"] else opt["res"]
        kw["residual"] = torch.randn(m, n, generator=g).to(dev, rdt)
    if opt.get("gamma"):
        kw["gamma"] = (torch.randn(n, generator=g) * 0.1).to(dev)
    if opt.get("q_width"):
        kw.update(q_scale=0.125, q_width=opt["q_width"])
    qm.reset_launch_counts()
    got = qm.int8_gemm(a8, sa, wt, ws, bias, **kw)
    again = qm.int8_gemm(a8, sa, wt, ws, bias, **kw)
    assert qm.launch_counts()["int8_gemm"] == 2
    ref = qm.int8_gemm_plain(a8, sa, wt, ws, bias, **kw)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == (m, n)
    assert torch.equal(got, again)
    if kw["act"] == "none":
        assert torch.equal(got, ref)
    else:
        ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), ref.float(), rtol=ulp,
                                   atol=1e-5)


# the attention kernels at ViT-g/14's (88) and ViT-bigG/14's (104) head
# widths: the flash kernel with bf16 output (K1, K2, K5) and with fp32 output
# over a pre-scaled q (K13), and its normalised-P instance (K12, K14), at
# the towers' S = 257 and at 577, keys past seq_len masked, in the packed and
# the grouped qkv layouts
WIDE_CASES = [
    # (B, S, heads, head_dim, group_heads, seq_len)
    (2, 257, 16, 88, None, None),
    (2, 257, 16, 104, 2, None),
    (2, 257, 16, 88, 2, 250),
    (3, 257, 2, 104, None, 200),
    (1, 577, 4, 88, 2, 500),
    (1, 577, 4, 104, None, 450),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,heads,d,group_heads,seq_len", WIDE_CASES)
def test_cuda_attention_at_wide_head_dims(b, s, heads, d, group_heads,
                                          seq_len):
    """Each of the three forms against its plain version within the
    attention tolerance, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(s + d + heads)
    qkv = (torch.randn(b, s, 3 * heads * d, generator=g) * 2).to(
        "cuda", torch.bfloat16)
    kw = dict(group_heads=group_heads)
    bk.reset_launch_counts()
    _assert_close(bk.attention(qkv, heads, seq_len, **kw),
                  bk.attention_plain(qkv, heads, seq_len, **kw),
                  TOL_ATTENTION)
    scaled = qkv * 0.25
    for norm_p in (False, True):
        kw.update(q_scaled=True, out_dtype=torch.float32, normalize_p=norm_p)
        got = bk.attention(scaled, heads, seq_len, **kw)
        assert got.dtype == torch.float32
        _assert_close(got, bk.attention_plain(scaled, heads, seq_len, **kw),
                      TOL_ATTENTION)
    assert bk.launch_counts()["attention"] == 3


@pytest.mark.gpu
def test_cuda_attention_refuses_other_head_dims():
    """A head width the kernels do not build raises before any launch, as
    does K6 past its backward's widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import attention as att

    bk.reset_launch_counts()
    for d in (32, 80, 96, 128):
        qkv = torch.zeros(1, 64, 3 * 2 * d, device="cuda",
                          dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            bk.attention(qkv, 2)
    assert bk.launch_counts()["attention"] == 0
    q = torch.zeros(1, 576, 2 * 88, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        att.fused_attention_fwd(q, q, q, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1024, 1664])
def test_cuda_k8_at_patch_14(width):
    """C4: K8 over the patch-14 im2col (K = 14 * 14 * 3 = 588, padded to 592
    in both operands) at ViT-L/14's and ViT-bigG/14's widths, batch 64
    (16,384 patch rows): bit for bit with its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator().manual_seed(width)
    k = 14 * 14 * 3
    x = torch.randn(64 * 256, k, generator=g).to("cuda", torch.bfloat16)
    w8, ws = quantize_weight((torch.randn(k, width, generator=g)
                              * k ** -0.5).cuda())
    wv = qm.int8_weight(w8)
    bias = torch.zeros(width, device="cuda")
    qm.reset_launch_counts()
    got = qm.quant_matmul_fused(x, wv, ws, bias)
    assert qm.launch_counts()["quant_matmul_fused"] == 1
    ref = qm.quant_matmul_fused_plain(x, wv, ws, bias)
    torch.cuda.synchronize()
    assert got.shape == (64 * 256, width) and torch.equal(got, ref)


# the flash kernel's normalised-P instance (K12, K14: two sweeps over the
# keys, P = exp(s - m) / l cast to bf16) at every head width it is built
# for, packed and grouped, at the paths' S (ViT-B/32's 50, ViT-B/16's 197,
# the LAION towers' 257, SO400M's 576/577), keys past seq_len masked
NORM_P_CASES = [
    # (B, S, heads, head_dim, group_heads, seq_len)
    (2, 197, 12, 64, None, None),
    (3, 50, 12, 64, None, 50),
    (2, 197, 4, 64, 2, 150),
    (1, 577, 16, 72, 2, None),
    (2, 576, 4, 72, None, 500),
    (2, 257, 16, 88, 2, None),
    (2, 257, 4, 104, None, 257),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,heads,d,group_heads,seq_len", NORM_P_CASES)
def test_cuda_attention_normalised_p(b, s, heads, d, group_heads, seq_len):
    """The normalised-P instance against ``attention_plain(normalize_p=
    True)`` within the attention tolerance, one launch, deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(b * s + d)
    qkv = (torch.randn(b, s, 3 * heads * d, generator=g) * 0.5).to(
        "cuda", torch.bfloat16)
    kw = dict(group_heads=group_heads, q_scaled=True, out_dtype=torch.float32,
              normalize_p=True)
    bk.reset_launch_counts()
    got = bk.attention(qkv, heads, seq_len, **kw)
    assert bk.launch_counts()["attention"] == 1 and got.dtype == torch.float32
    valid = slice(0, seq_len or s)
    _assert_close(got[:, valid], bk.attention_plain(qkv, heads, seq_len,
                                                    **kw)[:, valid],
                  TOL_ATTENTION)
    assert torch.equal(got, bk.attention(qkv, heads, seq_len, **kw))


# the int8 GEMM's quantized output (QOUT: y requantized inside the
# persistent launch, per whole row or per hidden chunk, each tile out of
# shared memory once its panel's row maxima are complete) at ragged M and
# N; the SO400M-wide case has 30 panels, each 34 tiles wide
QOUT_CASES = [
    # (name, M, K, N, act, group, group_pad, erf)
    ("gelu_tanh, one group, N = 8 x 43", 300, 1152, 344, "gelu_tanh", 0, 0,
     None),
    ("gelu_tanh, SO400M width, 30 panels", 3800, 256, 4304, "gelu_tanh",
     0, 0, None),
    ("quick_gelu, 2 chunks of 1536", 197, 768, 3072, "quick_gelu", 1536,
     1536, None),
    ("quick_gelu, 2 chunks of 168 padded to 192", 130, 256, 336,
     "quick_gelu", 168, 192, None),
    ("gelu_poly, 3 chunks of 2048", 257, 1408, 6144, "gelu_poly", 2048,
     2048, None),
    ("none, ConvNeXt width", 1000, 128, 512, "none", 0, 0, None),
    ("gelu_poly rational (act_pass + row_quant)", 70, 128, 136, "gelu_poly",
     0, 0, "rational"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", QOUT_CASES, ids=[c[0] for c in QOUT_CASES])
def test_cuda_int8_gemm_quantized_output(case, monkeypatch):
    """The quantized output equals the fp32 GEMM then row_quant on the card
    bit for bit, agrees with ``int8_gemm_plain``'s quantized output (codes
    within one, >= 99.9% equal; scales within the fp32 ulps of the
    activation), counts one launch and is deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    name, m, k, n, act, group, pad, erf = case
    if erf:
        monkeypatch.setenv("AIHAB_ERF_IMPL", erf)
    g = torch.Generator().manual_seed(m + n)
    dev = torch.device("cuda")
    a8, wt = (torch.randint(-127, 128, shape, generator=g,
                            dtype=torch.int8).to(dev)
              for shape in ((m, k), (n, k)))
    sa = (torch.rand(m, generator=g) * 0.02 + 1e-3).to(dev)
    ws = (torch.rand(n, generator=g) * 0.02 + 1e-3).to(dev)
    bias = (torch.randn(n, generator=g) * 0.1).to(dev)
    kw = dict(act=act, out_dtype=torch.int8, out_group=group,
              out_group_pad=pad)
    qm.reset_launch_counts()
    q, s = qm.int8_gemm(a8, sa, wt, ws, bias, **kw)
    assert qm.launch_counts()["int8_gemm"] == 1
    kg = group or n
    assert q.shape == (m, n // kg * max(pad, kg)) and s.shape == (m, n // kg)
    y = qm.int8_gemm(a8, sa, wt, ws, bias, act=act, out_dtype=torch.float32)
    q2, s2 = qm.row_quant(y, group=group, group_pad=pad)
    q3, s3 = qm.int8_gemm(a8, sa, wt, ws, bias, **kw)
    ref_q, ref_s = qm.int8_gemm_plain(a8, sa, wt, ws, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(q, q2) and torch.equal(s, s2)
    assert torch.equal(q, q3) and torch.equal(s, s3)
    d = (q.int() - ref_q.int()).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_cuda_int8_gemm_quantized_output_refusals():
    """What the quantized output does not take raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    a8 = torch.zeros(64, 256, dtype=torch.int8, device=dev)
    wt = torch.zeros(344, 256, dtype=torch.int8, device=dev)
    sa, ws, b = (torch.ones(64, device=dev), torch.ones(344, device=dev),
                 torch.zeros(344, device=dev))
    qm.reset_launch_counts()
    for kw in (dict(residual=torch.zeros(64, 344, device=dev)),
               dict(gamma=torch.ones(344, device=dev)), dict(q_width=8),
               dict(out_group=172), dict(out_group=43)):
        with pytest.raises(ValueError):
            qm.int8_gemm(a8, sa, wt, ws, b, out_dtype=torch.int8, **kw)
    assert qm.launch_counts()["int8_gemm"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 8], ids=["as many tiles as SMs",
                                               "8 columns more"])
def test_cuda_int8_gemm_quantized_output_at_the_sm_limit(extra):
    """A block of the quantized output waits for its panel's other tiles,
    so a row takes at most one 128-column tile per SM: at the limit one
    launch, bit for bit with the fp32 GEMM then row_quant; past it the
    kernel's form refuses and ``int8_gemm`` takes those two launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    m, k, n = 256, 128, 128 * qm._sm_count(dev) + extra
    g = torch.Generator().manual_seed(n)
    a8, wt = (torch.randint(-127, 128, shape, generator=g,
                            dtype=torch.int8).to(dev)
              for shape in ((m, k), (n, k)))
    sa = (torch.rand(m, generator=g) * 0.02 + 1e-3).to(dev)
    ws = (torch.rand(n, generator=g) * 0.02 + 1e-3).to(dev)
    bias = (torch.randn(n, generator=g) * 0.1).to(dev)
    qm.reset_launch_counts()
    q, s = qm.int8_gemm(a8, sa, wt, ws, bias, act="gelu_tanh",
                        out_dtype=torch.int8)
    assert qm.launch_counts()["int8_gemm"] == 1
    assert qm.launch_counts()["row_quant"] == (1 if extra else 0)
    y = qm.int8_gemm(a8, sa, wt, ws, bias, act="gelu_tanh",
                     out_dtype=torch.float32)
    q2, s2 = qm.row_quant(y)
    torch.cuda.synchronize()
    assert torch.equal(q, q2) and torch.equal(s, s2)
    if extra:
        with pytest.raises(ValueError, match="SMs"):
            qm._int8_gemm_qout(a8, sa, wt, ws, bias, "gelu_tanh", 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k,dtype,ln,fits", [
    (29056, torch.float32, True, True), (29060, torch.float32, True, False),
    (58116, torch.float32, False, False)])
def test_cuda_row_quant_width_limit(k, dtype, ln, fits):
    """``row_quant`` holds a row in a block's shared memory: a row at the
    limit quantizes as the plain version does, a wider one raises before a
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator().manual_seed(k)
    dev = torch.device("cuda")
    x = (torch.randn(4, k, generator=g) * 2).to(dev, dtype)
    lnp = ((1 + 0.1 * torch.randn(k, generator=g)).to(dev),
           (0.1 * torch.randn(k, generator=g)).to(dev)) if ln else ()
    qm.reset_launch_counts()
    if not fits:
        with pytest.raises(ValueError, match="shared memory"):
            qm.row_quant(x, *lnp)
        assert qm.launch_counts()["row_quant"] == 0
        return
    q, s = qm.row_quant(x, *lnp)
    ref_q, ref_s = qm.row_quant_plain(x, *lnp)
    torch.cuda.synchronize()
    d = (q.int() - ref_q.int()).abs()
    assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
    torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)


# row_quant, which reads each row once into shared memory, at the widths
# the paths quantize: the patch-14 im2col (588 bf16, rows not 16-byte
# aligned), ViT-B/16's and SO400M's rows, K13's groups padded to 160, a
# 4,304-wide fp32 row and a row past 48 KB of shared memory
ROW_QUANT_CASES = [
    # (M, K, dtype, LN, group, group_pad)
    (300, 588, torch.bfloat16, False, 0, 592),
    (197, 768, torch.bfloat16, True, 0, 0),
    (577, 1152, torch.float32, True, 144, 160),
    (130, 4304, torch.float32, False, 0, 0),
    (40, 13000, torch.float32, True, 0, 0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,dtype,ln,group,pad", ROW_QUANT_CASES)
def test_cuda_row_quant_reads_rows_once(m, k, dtype, ln, group, pad):
    """Without LN bit for bit with ``row_quant_plain``; with LN its codes
    within one and >= 99.9% equal (the LN's fp32 sums run in another order
    than the CPU's), its scales within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator().manual_seed(m + k)
    dev = torch.device("cuda")
    x = (torch.randn(m, k, generator=g) * 2).to(dev, dtype)
    lnp = ((1 + 0.1 * torch.randn(k, generator=g)).to(dev),
           (0.1 * torch.randn(k, generator=g)).to(dev)) if ln else ()
    kw = dict(group=group, group_pad=pad)
    q, s = qm.row_quant(x, *lnp, **kw)
    ref_q, ref_s = qm.row_quant_plain(x, *lnp, **kw)
    torch.cuda.synchronize()
    assert q.shape == ref_q.shape and s.shape == ref_s.shape
    if not ln:
        assert torch.equal(q, ref_q) and torch.equal(s, ref_s)
    else:
        d = (q.int() - ref_q.int()).abs()
        assert d.max().item() <= 1 and (d == 0).float().mean().item() >= 0.999
        torch.testing.assert_close(s, ref_s, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_cuda_runner_prolip_and_peft(tmp_path, monkeypatch):
    """The port's runner on the card on random:Tiny (2 blocks, head_dim 64):
    the ProLIP run encodes every cached view, the validation and the test
    split through K1 (2 launches a batch), and its projector equals
    ``train_projector`` on the CPU from the same cache (rel L2 <= 1e-4,
    fp32 both); the PEFT run trains with a 1-block K1 prefix and leaves
    its frozen leaves unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from aihab_clip_tpu_torch.cache import (feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.config import ConfigNode
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.runner import run
    from aihab_clip_tpu_torch.train.prolip import (ProjectorSpec,
                                                   train_projector)

    monkeypatch.chdir(tmp_path)
    tree = make_synthetic_cs_dataset(tmp_path, n_train_per_class=5,
                                     n_test_per_class=3, image_size=48)
    cfg = ConfigNode({
        "root_path": str(tmp_path), "dataset": "synth", "seed": 1, "shots": 0,
        "clip_backend": "openai", "backbone": "random:Tiny",
        "wandb_project": None, "train_epoch": 3, "lr_v": 1e-3,
        "lambda_v": 0.1, "search_lr": True, "feat_batch_size": 0,
        "save_features": True, "aug_views": 2,
        "use_hierarchical_prompts": False, "use_descriptive_prompts": False,
        "finetune": {"enabled": True, "unlocked_groups": 2,
                     "unlocked_layers": 1, "cache_embeddings": False},
        "data": {"dataset_paths": tree["dataset_paths"],
                 "index_file_names": tree["index_file_names"],
                 "batch_size": 8, "decode_prescale": False,
                 "data_split": {"valid_split": 0.25, "split_seed": 42},
                 "preprocessing": {"resize": 48, "resolution": 32,
                                   "augmentations": {"random_crop": True,
                                                     "rotation": True}}}})
    bk.reset_launch_counts()
    result = run(cfg, device="cuda")
    torch.cuda.synchronize()
    loaders, out = result["loaders"], result["prolip"]
    batches = 2 * len(loaders.train) + len(loaders.val) + len(loaders.test)
    assert bk.launch_counts()["full_block_fused"] == 2 * batches
    views, labels = read_preprojection_cache(feature_cache_dir(cfg), 2)
    tw = result["bundle"]["text_weights"].float().cpu()
    spec = ProjectorSpec.from_clip_model(result["bundle"]["model"]).to("cpu")
    ref, _ = train_projector(views, labels, tw, spec, out["lr"],
                             out["lambda"], 3, verbose=False, device="cpu")
    w = out["projector"].weight.cpu()
    assert ((w - ref.weight).norm() / ref.weight.norm()).item() <= 1e-4
    assert 0.0 <= out["acc"] <= 100.0

    peft_cfg = cfg.clone()
    peft_cfg.clip_backend = "openclip"
    peft_cfg.open_clip_model = "random:Tiny"
    peft_cfg.use_model_preprocess = False
    peft_cfg.train_epoch = 1
    bk.reset_launch_counts()
    res = run(peft_cfg, device="cuda")["peft"]
    torch.cuda.synchronize()
    assert bk.launch_counts()["full_block_fused"] > 0
    assert torch.isfinite(torch.tensor(res["test"]["loss"]))
    fresh = dict(load("random:Tiny", dtype=torch.bfloat16,
                      device="cuda").model.named_parameters())
    assert all(torch.equal(fresh[n], res["params"][n])
               for n, t in res["mask"].items() if not t)


@pytest.mark.gpu
def test_cuda_lora_and_staged_regimes(tmp_path, monkeypatch):
    """A10 on the card at a small size (random:Tiny, bf16): a LoRA run
    through the runner leaves every base weight bit-identical, moves its
    adapters and writes ``lora_adapters.npz``; ``ClassifierEngine(lora=)``
    serves it through K1 with the probabilities of an engine on the
    returned W_eff; the staged and the chunked epoch regimes train bit for
    bit as the host loop, with no upload per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.config import ConfigNode
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.runner import run
    from aihab_clip_tpu_torch.serving import ClassifierEngine
    from aihab_clip_tpu_torch.train import peft

    monkeypatch.chdir(tmp_path)
    tree = make_synthetic_cs_dataset(tmp_path, n_train_per_class=5,
                                     n_test_per_class=3, image_size=48)
    cfg = ConfigNode({
        "root_path": str(tmp_path), "dataset": "synth", "seed": 1, "shots": 0,
        "clip_backend": "openclip", "open_clip_model": "random:Tiny",
        "use_model_preprocess": False, "wandb_project": None,
        "train_epoch": 2, "lr_v": 1e-3, "device_dataset": False,
        "use_hierarchical_prompts": False, "use_descriptive_prompts": False,
        "finetune": {"enabled": True, "unlocked_groups": 2,
                     "unlocked_layers": 1, "cache_embeddings": False,
                     "lora_rank": 4, "lora_mlp": True, "save_model": True,
                     "save_model_dir": str(tmp_path / "ck")},
        "data": {"dataset_paths": tree["dataset_paths"],
                 "index_file_names": tree["index_file_names"],
                 "batch_size": 8, "decode_prescale": False,
                 "data_split": {"valid_split": 0.25, "split_seed": 42},
                 "preprocessing": {"resize": 48, "resolution": 32,
                                   "augmentations": {"random_crop": True}}}})
    result = run(cfg, device="cuda")
    out, model = result["peft"], result["bundle"]["model"]
    fresh = dict(load("random:Tiny", dtype=torch.bfloat16,
                      device="cuda").model.named_parameters())
    for name, p in model.named_parameters():
        assert torch.equal(p, fresh[name]), name
    assert all(ab["b"].abs().max() > 0 for ab in out["adapters"].values())
    eng = ClassifierEngine(model="random:Tiny", lora=out["adapters_path"],
                           batch_size=8, flat=True, verbose=False)
    ref = ClassifierEngine(model="random:Tiny", batch_size=8, flat=True,
                           verbose=False)
    with torch.no_grad():
        for name, p in ref.bundle.model.named_parameters():
            p.copy_(out["params"][name])
    from aihab_clip_tpu_torch.models.fast_vit import pack_fastest

    ref._packed = pack_fastest(ref.bundle.model, ref.bundle.config,
                               torch.bfloat16)
    imgs = np.random.default_rng(0).integers(0, 256, (8, 224, 224, 3),
                                             dtype=np.uint8)
    bk.reset_launch_counts()
    got = eng.classify_batch(imgs)
    assert bk.launch_counts()["full_block_fused"] == 2
    assert np.abs(got - ref.classify_batch(imgs)).max() == 0.0

    loaders = result["loaders"]
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    runs = {}
    for regime in (False, True, "chunked"):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        pcfg = peft.PEFTConfig(
            resolution=32, num_classes=20, lr=1e-3, epochs=2,
            compute_dtype=torch.bfloat16, device_dataset=regime,
            device_chunk_bytes=48 * 48 * 3 * 8 * 2)
        o = peft.finetune(model, loaders.train, None, loaders.test, pcfg,
                          text_weights=result["bundle"]["text_weights"],
                          unlocked_groups=2, seed=1, verbose=False)
        runs[regime] = (o, o["report"]["split_uploads"])
    steps = len(loaders.train)
    assert runs[False][1] == 3 * steps * 2 and runs[True][1] == 2 + 2 * 2
    for regime in (True, "chunked"):
        assert runs[regime][0]["test"]["loss"] == runs[False][0]["test"]["loss"]
        for name, t in runs[False][0]["params"].items():
            assert torch.equal(t, runs[regime][0]["params"][name]), name


def _exif_jpeg(data: bytes, orientation: int) -> bytes:
    """``data`` with an APP1 EXIF segment carrying ``orientation``."""
    import struct

    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body \
        + data[2:]


def _jpeg_batch():
    """Photos at every sampling the decode handles, gray, odd sizes and the
    eight EXIF orientations (the port's encoder: no cv2 on the card)."""
    import numpy as np

    from aihab_clip_tpu_torch.data.encode import encode_jpeg

    rng = np.random.default_rng(3)

    def photo(h, w):
        coarse = rng.normal(128, 60, (h // 8 + 2, w // 8 + 2, 3))
        img = np.repeat(np.repeat(coarse, 8, 0), 8, 1)[:h, :w]
        return np.clip(img + rng.normal(0, 12, (h, w, 3)), 0, 255) \
            .astype(np.uint8)

    blobs = []
    for h, w in ((256, 320), (301, 257), (37, 53), (17, 3)):
        for sampling in ((2, 2), (2, 1), (1, 1), (1, 2)):
            blobs.append(encode_jpeg(photo(h, w), 85, sampling))
        blobs.append(encode_jpeg(photo(h, w)[:, :, 0]))
    base = encode_jpeg(photo(96, 160), 90)
    blobs += [_exif_jpeg(base, o) for o in range(1, 9)]
    return blobs


@pytest.mark.gpu
@pytest.mark.parametrize("prescale_min", [0, 16, 40, 80])
def test_cuda_jpeg_kernels_match_plain(prescale_min):
    """J1 (every IDCT size the prescale picks: 8, 4, 2, 1) and J2 (4:2:0,
    4:2:2, 4:4:4, 4:4:0, gray, EXIF 1-8) against their plain versions on
    the same coefficients and planes: max|d| 0; and the whole card decode
    against data/decode.py's numpy pipeline, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J

    from torch_jpeg_batch import decode_batch

    dev = torch.device("cuda")
    blobs = _jpeg_batch()
    dim = 24
    headers = [D.parse_jpeg(b) for b in blobs]
    scales = [D.prescale_factor((h.width, h.height), prescale_min)
              for h in headers]
    plan = J.plan_batch(headers, scales, dim)
    coef = torch.empty(plan.coef_total, dtype=torch.int16)
    assert (J.entropy_decode(plan, blobs, coef) == 0).all()
    args = [torch.from_numpy(a) for a in (plan.qtables, plan.segs)]
    planes = torch.zeros(plan.plane_total, dtype=torch.uint8)
    J.jpeg_idct(coef, *args, planes)
    planes_d = torch.zeros_like(planes, device=dev)
    J.reset_launch_counts()
    J.jpeg_idct(coef.to(dev), *(a.to(dev) for a in args), planes_d)
    torch.cuda.synchronize()
    assert J.launch_counts()["jpeg_idct"] == 1
    assert torch.equal(planes_d.cpu(), planes)
    tabs = [torch.from_numpy(a) for a in (plan.photos, plan.taps_x,
                                          plan.taps_y)]
    out = torch.zeros(len(blobs), dim, dim, 3, dtype=torch.uint8)
    J.jpeg_color_resize(planes, *tabs, out)
    out_d = torch.zeros_like(out, device=dev)
    J.jpeg_color_resize(planes_d, *(t.to(dev) for t in tabs), out_d)
    torch.cuda.synchronize()
    assert J.launch_counts()["jpeg_color_resize"] == 1
    assert torch.equal(out_d.cpu(), out)
    got, ok = decode_batch(blobs, dim, "native", prescale_min,
                              "cuda")
    assert ok.all() and torch.equal(got.cpu(), out)
    for i, (b, h) in enumerate(zip(blobs, headers)):
        ref = D.resize_bilinear(D.reconstruct_jpeg(
            h, D.jpeg_coefficients(b, h), scales[i]), dim, dim)
        assert np.array_equal(out[i].numpy(), ref), i


@pytest.mark.gpu
def test_cuda_jpeg_idct_extreme_coefficients():
    """J1 at each IDCT size on blocks of extreme coefficients (+-32767,
    -32768) and 16-bit tables, a quarter of them dense and the others with
    only row 0, only the DC, or only row 0 and column 4 (the SIMD
    shortcut's cases): the arithmetic of data/decode.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J

    rng = np.random.default_rng(7)
    nb = 1024
    c = rng.choice([-32768, -32767, -2047, -1, 0, 1, 2047, 32767],
                   (nb, 64)).astype(np.int16)
    c[1::4, 8:] = 0
    c[2::4, 1:] = 0
    col4 = np.ones(64, bool)
    col4[:8] = col4[4::8] = False
    c[3::4, col4] = 0
    q = rng.choice([1, 255, 1000, 65535], (2, 64)).astype(np.uint16)
    for s in (8, 4, 2, 1):
        for qi in range(2):
            packed = torch.from_numpy(J.pack_blocks(c, s))
            segs = torch.tensor([[0, 0, 16, nb, s, qi, 0, 0]])
            planes = torch.zeros(nb * s * s, dtype=torch.uint8, device="cuda")
            J.jpeg_idct(packed.reshape(-1).cuda(), torch.from_numpy(q).cuda(),
                        segs.cuda(), planes)
            ref = D.idct_scaled(c.reshape(nb, 8, 8), q[qi].reshape(8, 8), s)
            want = ref.reshape(nb // 16, 16, s, s).transpose(0, 2, 1, 3)
            assert np.array_equal(planes.cpu().numpy(), want.reshape(-1)), \
                (s, qi)


@pytest.mark.gpu
def test_cuda_jpeg_formats_match_plain():
    """The A9b JPEGs on the card (tools/jpeg_fixtures.py writes them: the
    card's machine has no cv2): progressive re-codes, a cut baseline and a
    cut progressive one (its interblock smoothing), CMYK and YCCK.  J1, J2
    and J2's four-component instance equal their plain versions, max|d| 0,
    and the card decode on the server's route equals data/decode.py's
    pipeline bit for bit at m = 8 and 2 (CMYK and YCCK at full scale, as
    JAX's decode_bytes takes them through cv2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.tools import jpeg_fixtures as F
    from torch_jpeg_batch import decode_batch

    base = _jpeg_batch()
    prog = [F.progressive_recode(b) for b in base[:5]]
    cut = [base[0][:len(base[0]) * 3 // 5], prog[0][:len(prog[0]) // 2]]
    adobe = [F.encode_adobe(F.adobe_planes(96, 160, 1), 0),
             F.encode_adobe(F.adobe_planes(77, 50, 2), 2, 90, (2, 2))]
    blobs = prog + cut + adobe
    dim = 24
    for prescale_min in (0, 40):
        J.reset_launch_counts()
        got, ok = decode_batch(blobs, dim, "serve", prescale_min,
                                   "cuda")
        assert ok.all()
        counts = J.launch_counts()
        assert counts == {"jpeg_idct": 1, "jpeg_color_resize": 1,
                          "jpeg_color_resize_cmyk": 1}
        plain, ok_p = decode_batch(blobs, dim, "serve",
                                       prescale_min)
        assert ok_p.all() and torch.equal(got, plain)
        for i, b in enumerate(blobs):
            h = D.parse_jpeg(b)
            m = 8 if len(h.comps) == 4 else D.prescale_factor(
                (h.width, h.height), prescale_min)
            ref = D.resize_bilinear(D.reconstruct_jpeg(
                h, D.jpeg_coefficients(b, h), m), dim, dim)
            assert np.array_equal(got[i].numpy(), ref), i
    for p, b in zip(prog, base):
        for x, y in zip(J.coefficients(p), J.coefficients(b)):
            assert np.array_equal(x, y)
