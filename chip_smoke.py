#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aihab_clip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (any failure raises and the exit code is non-zero):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile ``aihab_clip_tpu_torch/csrc/block_kernels.cu`` into
     ``build/`` and print nvcc's seconds and ptxas register/smem report;
  3. kernels — every block kernel at ViT-B/16 shapes (B=64, S=197, W=768,
     12 heads, hidden 3072, bf16) and at SigLIP SO400M shapes (B=64, S=576,
     W=1152, 16 heads of 72, hidden 4304 in two 2152-wide chunks, bf16)
     against its plain PyTorch version on the card, with CUDA-event times
     beside the plain version, a one-call PyTorch yardstick where one
     exists, and the roofline bound;
  4. ViT path — ``ClassifierEngine("random:ViT-B/16", batch_size=64)``
     answers >= 150 single-image requests through ``DynamicBatcher``; the
     launch counters show every block went through the kernels; projected
     features agree with the fp32 canonical module on the card; the
     ``merge_blocks="off"`` path (K2 + K3) is driven and read the same way;
     end-to-end ``classify_batch`` images/s at batch 64 and 256;
  5. SigLIP path — ``ClassifierEngine("random:ViT-SO400M-16-SigLIP2-384",
     batch_size=64)`` answers >= 96 single 384x384 requests through
     ``DynamicBatcher``, every block through ``attn_block_split`` (K5) and
     ``mlp_block_split`` (K4); features against the fp32 canonical module
     on the card; the batch-64 device-time split; ``classify_batch``
     images/s at batch 64;
  6. one JSON line listing every kernel; last line ``{"ok": true, ...}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
B, S, W, HEADS, HIDDEN = 64, 197, 768, 12, 3072
# SigLIP SO400M-16-384 (models/siglip.py SIGLIP_ARCHS)
SL_S, SL_W, SL_HEADS, SL_HIDDEN, SL_GROUPS, SL_CHUNKS = 576, 1152, 16, 4304, 8, 2
SL_LAYERS, SL_MODEL = 27, "random:ViT-SO400M-16-SigLIP2-384"
PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
N_REQUESTS = 160
SL_REQUESTS = 96
SRC = "aihab_clip_tpu_torch/csrc/block_kernels.cu"
JAX_BK = "aihab_clip_tpu/ops/block_kernel.py"
# tolerances against the plain version on the same inputs, as (rel L2,
# max|d| / max|ref|): both round to bf16 at the same points, so they differ
# where an fp32 sum lands on the other side of a bf16 rounding boundary
# (1 ulp = 2^-8 relative) and through what such a flip feeds downstream
# inside a block.  Attention also rounds P to bf16 against its running
# (online) row max where the plain version uses the final row max, and
# applies 1/sum to the output rows where K5's plain version normalises P
# before its cast.
TOL = {"kernel": (2e-3, 0.02), "attention": (5e-3, 0.02),
       "block": (1e-2, 0.04)}
COS_MIN = 0.999


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "script needs one CUDA card", file=sys.stderr)
        sys.exit(2)

    from aihab_clip_tpu_torch.ops import _build
    from aihab_clip_tpu_torch.ops import block_kernel as bk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[device] torch.cuda.get_device_name(0)={kind!r} count="
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f}s total, nvcc "
          f"{_build.build_info.get('seconds')}s -> {_build.build_info['path']}")
    for line in _build.build_info.get("ptxas", "").splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry")):
            print(f"[build] {line.strip()}")

    # ---- 3. kernels at ViT-B/16 shapes
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)

    def vec(n, scale=0.1, one=False):
        return (1.0 if one else 0.0) + rnd(n, scale=scale, dtype=torch.float32)

    def timed(fn, iters=20):
        for _ in range(3):
            fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    def compare(name, out, ref, kind_):
        torch.cuda.synchronize()
        out, ref = out.float(), ref.float()
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        d = (out - ref).abs()
        err = d.max().item()
        rel = ((out - ref).norm() / ref.norm()).item()
        tol_rel, tol_max = TOL[kind_]
        lim = tol_max * ref.abs().max().item()
        print(f"[kernels] {name}: max|d| {err:.6g} (limit {lim:.6g}), rel L2 "
              f"{rel:.3e} (limit {tol_rel:g})")
        check(rel <= tol_rel and err <= lim, f"{name} disagrees with its "
              f"plain version (max {err}, rel {rel})")
        return err, rel, lim

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    rows = []

    def run_cases(cases):
        """Each case: (name, replaces, tolerance kind, kernel fn, plain fn,
        library fn or None, flops, bytes, launch counter, path)."""
        for (name, replaces, kind_, fn, plain, lib, flops, nbytes, counter,
             path) in cases:
            err, rel, lim = compare(name, fn(), plain(), kind_)
            ms, plain_ms = timed(fn), timed(plain, iters=5)
            lib_ms = timed(lib) if lib is not None else None
            b_ms, b_by = bound(flops, nbytes)
            print(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}, "
                  f"bound {b_ms:.4f} by {b_by}; {flops / ms / 1e9:.1f} "
                  f"TFLOP/s)")
            rows.append(dict(name=name, route="cuda", source=SRC,
                             replaces=replaces, launches=None,
                             counter=counter, path=path, max_abs_err=err,
                             tol_max_abs=lim, rel_l2=rel,
                             tol_rel_l2=TOL[kind_][0], ms=ms,
                             tflops=flops / ms / 1e9, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
            torch.cuda.empty_cache()

    m = B * S
    x = rnd(B, S, W)
    p = dict(ln1_scale=vec(W, one=True), ln1_bias=vec(W),
             w_qkv=rnd(W, 3 * W, scale=W ** -0.5), b_qkv=vec(3 * W),
             w_out=rnd(W, W, scale=W ** -0.5), b_out=vec(W),
             ln2_scale=vec(W, one=True), ln2_bias=vec(W),
             w_fc=rnd(W, HIDDEN, scale=W ** -0.5), b_fc=vec(HIDDEN),
             w_proj=rnd(HIDDEN, W, scale=HIDDEN ** -0.5), b_proj=vec(W))
    x2 = x.reshape(m, W)
    qkv = bk.ln_gemm(x2, p["ln1_scale"], p["ln1_bias"], p["w_qkv"], p["b_qkv"])
    attn = bk.attention(qkv.reshape(B, S, 3 * W), HEADS)
    y1 = bk.gemm_residual(attn.reshape(m, W), p["w_out"], p["b_out"], x2,
                          out_dtype=torch.float32)
    h = bk.ln_gemm(y1, p["ln2_scale"], p["ln2_bias"], p["w_fc"], p["b_fc"],
                   act="quick_gelu")
    flops_qkv, flops_out = 2 * m * W * 3 * W, 2 * m * W * W
    flops_fc = flops_proj = 2 * m * W * HIDDEN
    flops_att = 4 * B * HEADS * S * S * (W // HEADS)
    w_bytes = 2 * (4 * W * W + 2 * W * HIDDEN)
    sdpa_q, sdpa_k, sdpa_v = (t.reshape(B, S, HEADS, W // HEADS).transpose(1, 2)
                              for t in qkv.reshape(B, S, 3 * W).split(W, -1))
    key_ok = torch.ones(1, 1, 1, S, dtype=torch.bool, device=dev)
    bias_bf = {k: p[k].to(torch.bfloat16) for k in ("b_qkv", "b_out", "b_fc",
                                                      "b_proj")}

    run_cases([
        ("ln_gemm[qkv]", f"{JAX_BK}:1027", "kernel",
         lambda: bk.ln_gemm(x2, p["ln1_scale"], p["ln1_bias"], p["w_qkv"],
                            p["b_qkv"]),
         lambda: bk.ln_gemm_plain(x2, p["ln1_scale"], p["ln1_bias"],
                                  p["w_qkv"], p["b_qkv"]),
         lambda: torch.addmm(bias_bf["b_qkv"], x2, p["w_qkv"]),
         flops_qkv, 2 * m * W + 2 * W * 3 * W + 2 * m * 3 * W, bk.ln_gemm,
         "vit"),
        ("attention", f"{JAX_BK}:896", "attention",
         lambda: bk.attention(qkv.reshape(B, S, 3 * W), HEADS),
         lambda: bk.attention_plain(qkv.reshape(B, S, 3 * W), HEADS),
         lambda: torch.nn.functional.scaled_dot_product_attention(
             sdpa_q, sdpa_k, sdpa_v, attn_mask=key_ok),
         flops_att, 2 * m * 3 * W + 2 * m * W, bk.attention, "vit"),
        ("gemm_residual[out_proj]", f"{JAX_BK}:1038", "kernel",
         lambda: bk.gemm_residual(attn.reshape(m, W), p["w_out"], p["b_out"],
                                  x2, out_dtype=torch.float32),
         lambda: bk.gemm_residual_plain(attn.reshape(m, W), p["w_out"],
                                        p["b_out"], x2,
                                        out_dtype=torch.float32),
         lambda: torch.addmm(bias_bf["b_out"], attn.reshape(m, W), p["w_out"]),
         flops_out, 2 * m * W + 2 * W * W + 2 * m * W + 4 * m * W,
         bk.gemm_residual, "vit"),
        ("ln_gemm[c_fc]", f"{JAX_BK}:1048", "kernel",
         lambda: bk.ln_gemm(y1, p["ln2_scale"], p["ln2_bias"], p["w_fc"],
                            p["b_fc"], act="quick_gelu"),
         lambda: bk.ln_gemm_plain(y1, p["ln2_scale"], p["ln2_bias"],
                                  p["w_fc"], p["b_fc"], act="quick_gelu"),
         lambda: torch.addmm(bias_bf["b_fc"], x2, p["w_fc"]),
         flops_fc, 4 * m * W + 2 * W * HIDDEN + 2 * m * HIDDEN, bk.ln_gemm,
         "vit"),
        ("gemm_residual[c_proj]", f"{JAX_BK}:1051", "kernel",
         lambda: bk.gemm_residual(h, p["w_proj"], p["b_proj"], y1,
                                  out_dtype=torch.bfloat16),
         lambda: bk.gemm_residual_plain(h, p["w_proj"], p["b_proj"], y1,
                                        out_dtype=torch.bfloat16),
         lambda: torch.addmm(bias_bf["b_proj"], h, p["w_proj"]),
         flops_proj, 2 * m * HIDDEN + 2 * HIDDEN * W + 4 * m * W + 2 * m * W,
         bk.gemm_residual, "vit"),
        ("full_block_fused", f"{JAX_BK}:1056", "block",
         lambda: bk.full_block_fused(x, **p, heads=HEADS),
         lambda: bk.full_block_fused_plain(x, **p, heads=HEADS),
         None, flops_qkv + flops_att + flops_out + flops_fc + flops_proj,
         4 * m * W + w_bytes, bk.full_block_fused, "vit"),
        ("attn_block_fused", f"{JAX_BK}:85", "block",
         lambda: bk.attn_block_fused(x, *list(p.values())[:6], HEADS),
         lambda: bk.attn_block_fused_plain(x, *list(p.values())[:6], HEADS),
         None, flops_qkv + flops_att + flops_out,
         4 * m * W + 2 * 4 * W * W, bk.attn_block_fused, "vit_off"),
        ("mlp_block_fused", f"{JAX_BK}:613", "block",
         lambda: bk.mlp_block_fused(x2, *list(p.values())[6:]),
         lambda: bk.mlp_block_fused_plain(x2, *list(p.values())[6:]),
         None, flops_fc + flops_proj, 4 * m * W + 2 * 2 * W * HIDDEN,
         bk.mlp_block_fused, "vit_off"),
    ])

    # what the LN prologue costs at the c_fc shape ([m, W] @ [W, HIDDEN])
    breakdown = {
        "fp32 input + LN": lambda: bk.ln_gemm(y1, p["ln2_scale"], p["ln2_bias"],
                                              p["w_fc"], p["b_fc"]),
        "bf16 input + LN": lambda: bk.ln_gemm(x2, p["ln2_scale"], p["ln2_bias"],
                                              p["w_fc"], p["b_fc"]),
        "bf16 input, no LN (gemm_residual)": lambda: bk.gemm_residual(
            x2, p["w_fc"], p["b_fc"], h),
    }
    for label, fn in breakdown.items():
        ms = timed(fn)
        print(f"[kernels] c_fc-shape GEMM, {label}: {ms:.4f} ms "
              f"({flops_fc / ms / 1e9:.1f} TFLOP/s)")

    for act in ("gelu_tanh", "gelu_poly"):
        xs = rnd(130, 128, scale=2.0)
        args = (vec(128, one=True), vec(128), rnd(128, 512, scale=128 ** -0.5),
                vec(512))
        compare(f"ln_gemm[{act}, 130x128x512]", bk.ln_gemm(*(xs,) + args, act=act),
                bk.ln_gemm_plain(*(xs,) + args, act=act), "kernel")
    del x, x2, qkv, attn, y1, h, sdpa_q, sdpa_k, sdpa_v

    # ---- 3b. kernels at SigLIP SO400M shapes
    siglip_kernel_cases(bk, rnd, vec, run_cases)

    # ---- 4. the ViT path: engine + dynamic batcher
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.models.fast_vit import (encode_image_fastest,
                                                     vit_encode_block_fused)
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    t0 = time.perf_counter()
    engine = ClassifierEngine(model="random:ViT-B/16", batch_size=64,
                              device="cuda")
    engine.warmup()
    print(f"[path] engine built + warm in {time.perf_counter() - t0:.1f}s")
    images = np.random.default_rng(SEED).integers(
        0, 256, (N_REQUESTS, 224, 224, 3), dtype=np.uint8)

    bk.reset_launch_counts()
    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    batcher.start()
    t0 = time.perf_counter()
    futures = [batcher.submit(img) for img in images]
    probs = np.stack([f.result(timeout=600) for f in futures])
    wall = time.perf_counter() - t0
    batcher.stop()
    counts = {"vit": bk.launch_counts()}
    n_batches = batcher.stats.batches
    print(f"[path] {len(futures)} requests answered in {wall:.3f}s over "
          f"{n_batches} batches; launches {counts['vit']}")
    check(probs.shape == (N_REQUESTS, 20), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)), "rows not softmax")
    check(counts["vit"]["full_block_fused"] == 12 * n_batches,
          f"full_block_fused launched {counts['vit']['full_block_fused']} "
          f"times for {n_batches} batches (want 12 each)")
    for k in ("ln_gemm", "gemm_residual"):
        check(counts["vit"][k] == 24 * n_batches, f"{k} count {counts['vit'][k]}")
    check(counts["vit"]["attention"] == 12 * n_batches, "attention count")

    # projected features vs the fp32 canonical module on the card
    ref = load("random:ViT-B/16", dtype=torch.float32, device="cuda", seed=0)
    cfg = engine.bundle.config
    batch = torch.from_numpy(images[:B]).to(dev)
    with torch.inference_mode():
        xb = eval_transform(batch, 224, dtype=torch.bfloat16)
        feats = encode_image_fastest(engine.bundle.model, xb, cfg, project=True,
                                     packed=engine._packed)[1].float()
        ref_feats = ref.model.encode_image(eval_transform(batch, 224),
                                           project=True)[1]
        cos = torch.nn.functional.cosine_similarity(feats, ref_feats, dim=-1)
        print(f"[path] merged-block features vs fp32 canonical module: cosine "
              f"min {cos.min().item():.6f} mean {cos.mean().item():.6f}")
        check(cos.min().item() >= COS_MIN, "merged path cosine")
        ref_probs = torch.softmax(100.0 * torch.nn.functional.normalize(
            ref_feats, dim=-1) @ engine._text_weights, -1).cpu().numpy()
        agree = float((ref_probs.argmax(-1) == probs[:B].argmax(-1)).mean())
        print(f"[path] engine top-1 vs fp32 canonical: {agree:.4f} agreement, "
              f"max|dprob| {np.abs(ref_probs - probs[:B]).max():.4g}")

        # the two-kernel halves (K2 + K3) as a path of its own
        bk.reset_launch_counts()
        off = vit_encode_block_fused(engine._packed, xb, cfg, project=True,
                                     merge_blocks="off")[1].float()
        torch.cuda.synchronize()
        counts["vit_off"] = bk.launch_counts()
        cos_off = torch.nn.functional.cosine_similarity(off, ref_feats, dim=-1)
        print(f"[path] merge_blocks='off' launches {counts['vit_off']}; cosine "
              f"min {cos_off.min().item():.6f}")
        check(counts["vit_off"]["attn_block_fused"] == 12
              and counts["vit_off"]["mlp_block_fused"] == 12, "K2/K3 counts")
        check(cos_off.min().item() >= COS_MIN, "merge_blocks='off' cosine")
    del ref

    # where the time goes at batch 64 (CUDA events)
    with torch.inference_mode():
        t_pre = timed(lambda: eval_transform(batch, 224, dtype=torch.bfloat16), 10)
        t_enc = timed(lambda: encode_image_fastest(
            engine.bundle.model, xb, cfg, project=True, packed=engine._packed), 5)
        t_all = timed(lambda: engine.classify(batch), 5)
    print(f"[path] batch 64 device time: classify {t_all:.3f} ms = eval_transform "
          f"{t_pre:.3f} + encode {t_enc:.3f} + head/rest "
          f"{t_all - t_pre - t_enc:.3f}")

    # end-to-end classify_batch images/s (host clock, result on the host)
    rates = {}
    for bs in (64, 256):
        eng = engine if bs == 64 else ClassifierEngine(
            model="random:ViT-B/16", batch_size=bs, buckets=1, device="cuda",
            verbose=False)
        rates[f"vit_b16_{bs}"] = images_per_s(eng, bs, 224)
        print(f"[path] classify_batch end-to-end at batch {bs}: "
              f"{rates[f'vit_b16_{bs}']:.1f} images/s ({smi})")
        del eng
    del engine, batch, xb
    torch.cuda.empty_cache()

    # ---- 5. the SigLIP path: engine + dynamic batcher
    counts["siglip"], rates["siglip_so400m_64"] = siglip_path(bk, timed)

    # ---- 6. kernels line + result
    names = {"vit": "ViT-B/16 engine + DynamicBatcher",
             "vit_off": "ViT-B/16 merge_blocks='off' encode",
             "siglip": "SigLIP SO400M engine + DynamicBatcher"}
    for row in rows:
        counter = row.pop("counter").__name__
        row["launches"] = counts[row["path"]][counter]
        row["path"] = names[row["path"]]
        check(row["launches"] > 0, f"{row['name']} never launched on its path")
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": rows, "card": smi, "images_per_s": rates}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def images_per_s(engine, bs: int, dim: int, n: int = 10) -> float:
    """End-to-end ``classify_batch`` images/s on the host clock, from host
    uint8 arrays to host probabilities."""
    u8 = np.random.default_rng(SEED + bs).integers(
        0, 256, (bs, dim, dim, 3), dtype=np.uint8)
    for _ in range(2):
        engine.classify_batch(u8)
    t0 = time.perf_counter()
    for _ in range(n):
        engine.classify_batch(u8)
    return n * bs / (time.perf_counter() - t0)


def siglip_kernel_cases(bk, rnd, vec, run_cases) -> None:
    """The SigLIP path's kernels at SO400M shapes, batch 64: attention at
    head_dim 72 (grouped q-scaled, and packed), ln_gemm with the q-scale
    epilogue, the 2152-wide MLP chunk GEMMs (ragged N and K edges, a
    column-slice weight), and K5/K4 whole."""
    import math

    import torch

    from aihab_clip_tpu_torch.ops.block_kernel import regroup_attn_weights_f

    b, s, w, heads, hid = B, SL_S, SL_W, SL_HEADS, SL_HIDDEN
    d, g, ch = w // heads, SL_HEADS // SL_GROUPS, SL_HIDDEN // SL_CHUNKS
    m = b * s
    sdpa = torch.nn.functional.scaled_dot_product_attention
    x = rnd(b, s, w)
    x2 = x.reshape(m, w)
    ln1, ln2 = (vec(w, one=True), vec(w)), (vec(w, one=True), vec(w))
    wqkv_g, b_qkv_g, wout_g = regroup_attn_weights_f(
        rnd(w, 3 * w, scale=w ** -0.5), vec(3 * w), rnd(w, w, scale=w ** -0.5),
        heads, SL_GROUPS)
    wqkv = wqkv_g.permute(1, 0, 2).reshape(w, -1).contiguous()  # the pack
    bqkv, wout, b_out = b_qkv_g.reshape(-1), wout_g.reshape(w, w), vec(w)
    w_fc, b_fc = rnd(w, hid, scale=w ** -0.5), vec(hid)
    w_proj, b_proj = rnd(hid, w, scale=hid ** -0.5), vec(w)
    qkw = dict(eps=1e-6, q_scale=1.0 / math.sqrt(d), q_width=g * d)
    qkv_g = bk.ln_gemm(x2, *ln1, wqkv, bqkv, **qkw).reshape(b, s, 3 * w)
    qkv_p = bk.ln_gemm(x2, *ln1, wqkv, bqkv, eps=1e-6).reshape(b, s, 3 * w)
    # grouped columns (group, q|k|v, head in group, d) -> [b, heads, s, d]
    q_g, k_g, v_g = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                     for t in qkv_g.reshape(b, s, SL_GROUPS, 3, g, d).unbind(3))
    q_p, k_p, v_p = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                     for t in qkv_p.split(w, -1))
    attn = bk.attention(qkv_g, heads, group_heads=g, q_scaled=True)
    h = bk.ln_gemm(x2, *ln2, w_fc[:, :ch], b_fc[:ch], act="gelu_tanh", eps=1e-6)
    part = bk.gemm_residual(h, w_proj[:ch], b_proj, x2)
    bias_bf = {"qkv": bqkv.bfloat16(), "out": b_out.bfloat16(),
               "fc1": b_fc[ch:].bfloat16()}
    f_qkv, f_out = 2 * m * w * 3 * w, 2 * m * w * w
    f_att = 4 * b * heads * s * s * d
    f_chunk = 2 * m * w * ch
    att_bytes = 2 * m * 3 * w + 2 * m * w
    print(f"[kernels] SigLIP SO400M shapes: B={b} S={s} W={w} {heads}x{d} "
          f"hidden {hid} ({SL_CHUNKS} chunks of {ch}), {SL_GROUPS} groups")
    run_cases([
        ("ln_gemm[SO400M qkv, q-scale]", f"{JAX_BK}:795", "kernel",
         lambda: bk.ln_gemm(x2, *ln1, wqkv, bqkv, **qkw),
         lambda: bk.ln_gemm_plain(x2, *ln1, wqkv, bqkv, **qkw),
         lambda: torch.addmm(bias_bf["qkv"], x2, wqkv),
         f_qkv, 2 * m * w + 2 * w * 3 * w + 2 * m * 3 * w, bk.ln_gemm,
         "siglip"),
        ("attention[hd72, grouped, q-scaled]", f"{JAX_BK}:804", "attention",
         lambda: bk.attention(qkv_g, heads, group_heads=g, q_scaled=True),
         lambda: bk.attention_plain(qkv_g, heads, group_heads=g,
                                    q_scaled=True),
         lambda: sdpa(q_g, k_g, v_g, scale=1.0),
         f_att, att_bytes, bk.attention, "siglip"),
        ("attention[hd72, packed]", f"{JAX_BK}:896", "attention",
         lambda: bk.attention(qkv_p, heads),
         lambda: bk.attention_plain(qkv_p, heads),
         lambda: sdpa(q_p, k_p, v_p),
         f_att, att_bytes, bk.attention, "siglip"),
        ("gemm_residual[SO400M out_proj, groups]", f"{JAX_BK}:818", "kernel",
         lambda: bk.gemm_residual(attn.reshape(m, w), wout, b_out, x2),
         lambda: bk.gemm_residual_plain(attn.reshape(m, w), wout, b_out, x2),
         lambda: torch.addmm(bias_bf["out"], attn.reshape(m, w), wout),
         f_out, 2 * m * w + 2 * w * w + 2 * m * w + 2 * m * w,
         bk.gemm_residual, "siglip"),
        ("ln_gemm[SO400M c_fc chunk 1 of 2, 2152 wide]", f"{JAX_BK}:491",
         "kernel",
         lambda: bk.ln_gemm(x2, *ln2, w_fc[:, ch:], b_fc[ch:],
                            act="gelu_tanh", eps=1e-6),
         lambda: bk.ln_gemm_plain(x2, *ln2, w_fc[:, ch:], b_fc[ch:],
                                  act="gelu_tanh", eps=1e-6),
         lambda: torch.addmm(bias_bf["fc1"], x2, w_fc[:, ch:]),
         f_chunk, 2 * m * w + 2 * w * ch + 2 * m * ch, bk.ln_gemm, "siglip"),
        ("gemm_residual[SO400M c_proj chunk 2 of 2, K=2152]", f"{JAX_BK}:494",
         "kernel",
         lambda: bk.gemm_residual(h, w_proj[ch:], None, part),
         lambda: bk.gemm_residual_plain(h, w_proj[ch:], None, part),
         lambda: torch.addmm(part, h, w_proj[ch:]),
         f_chunk, 2 * m * ch + 2 * ch * w + 2 * m * w + 2 * m * w,
         bk.gemm_residual, "siglip"),
        ("attn_block_split", f"{JAX_BK}:834", "block",
         lambda: bk.attn_block_split(x, wqkv, b_qkv_g, wout_g, b_out, *ln1,
                                     heads, SL_GROUPS, ln_eps=1e-6),
         lambda: bk.attn_block_split_plain(x, wqkv, b_qkv_g, wout_g, b_out,
                                           *ln1, heads, SL_GROUPS,
                                           ln_eps=1e-6),
         None, f_qkv + f_att + f_out, 4 * m * w + 2 * 4 * w * w,
         bk.attn_block_split, "siglip"),
        ("mlp_block_split", f"{JAX_BK}:525", "block",
         lambda: bk.mlp_block_split(x2, *ln2, w_fc, b_fc, w_proj, b_proj,
                                    n_chunks=SL_CHUNKS, act="gelu_tanh",
                                    ln_eps=1e-6),
         lambda: bk.mlp_block_split_plain(x2, *ln2, w_fc, b_fc, w_proj,
                                          b_proj, n_chunks=SL_CHUNKS,
                                          act="gelu_tanh", ln_eps=1e-6),
         None, 2 * 2 * m * w * hid, 4 * m * w + 2 * 2 * w * hid,
         bk.mlp_block_split, "siglip"),
    ])
    k5_ops, k4_ops = f_qkv + f_att + f_out, 4 * m * w * hid
    print(f"[kernels] SO400M bound per block at batch {b}: K5 "
          f"{k5_ops / 1e9:.1f} GFLOP ({1e3 * k5_ops / PEAK_FLOPS:.4f} ms), K4 "
          f"{k4_ops / 1e9:.1f} GFLOP ({1e3 * k4_ops / PEAK_FLOPS:.4f} ms); "
          f"{SL_LAYERS} blocks {1e3 * SL_LAYERS * (k5_ops + k4_ops) / PEAK_FLOPS:.2f} ms")


def siglip_path(bk, timed):
    """ClassifierEngine + DynamicBatcher on random SO400M weights; returns
    the launch counts of the batcher run and images/s at batch 64."""
    import torch

    from aihab_clip_tpu_torch.models.fast_siglip import (
        _apply_fused_siglip_blocks, _siglip_embed)
    from aihab_clip_tpu_torch.models.fast_vit import encode_image_fastest
    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine = ClassifierEngine(model=SL_MODEL, batch_size=64, device="cuda")
    t_built = time.perf_counter() - t0
    engine.warmup()
    cfg = engine.bundle.config
    res, dim = cfg.image_resolution, engine.decode_dim
    print(f"[siglip] {SL_MODEL}: built in {t_built:.1f}s, warm in "
          f"{time.perf_counter() - t0:.1f}s; {cfg.vision_layers} blocks, "
          f"{engine._packed['n_groups']} head groups, "
          f"{engine._packed['mlp_chunks']} MLP chunks, decode {dim}px")
    check((cfg.vision_width, cfg.vision_heads, cfg.vision_mlp_dim, res) ==
          (SL_W, SL_HEADS, SL_HIDDEN, 384), f"config {cfg}")
    check((engine._packed["n_groups"], engine._packed["mlp_chunks"]) ==
          (SL_GROUPS, SL_CHUNKS), "grouping / chunks")
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (SL_REQUESTS, dim, dim, 3), dtype=np.uint8)

    bk.reset_launch_counts()
    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    batcher.start()
    t0 = time.perf_counter()
    futures = [batcher.submit(img) for img in images]
    probs = np.stack([f.result(timeout=600) for f in futures])
    wall = time.perf_counter() - t0
    batcher.stop()
    counts = bk.launch_counts()
    n = batcher.stats.batches
    print(f"[siglip] {len(futures)} requests answered in {wall:.3f}s over {n} "
          f"batches; launches {counts}")
    check(probs.shape == (SL_REQUESTS, 20), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)), "rows not softmax")
    for k in ("attn_block_split", "mlp_block_split", "attention"):
        check(counts[k] == SL_LAYERS * n, f"{k} launched {counts[k]} times "
              f"for {n} batches (want {SL_LAYERS} each)")
    for k in ("ln_gemm", "gemm_residual"):
        check(counts[k] == SL_LAYERS * (1 + SL_CHUNKS) * n, f"{k} count "
              f"{counts[k]}")
    check(counts["full_block_fused"] == 0, "K1 on the SigLIP path")

    # features vs the fp32 canonical tower on the card, same parameters
    # (the engine's tower with its compute dtype set to fp32)
    ref_tower = copy.copy(engine.bundle.model.visual)
    ref_tower.dtype = torch.float32
    mean, std = normalize_stats_for(cfg)
    n_ref = 16
    batch = torch.from_numpy(images[:64]).to(dev)
    with torch.inference_mode():
        xb = eval_transform(batch, res, dtype=torch.bfloat16, mean=mean,
                            std=std)
        feats = encode_image_fastest(engine.bundle.model, xb[:n_ref], cfg,
                                     project=True,
                                     packed=engine._packed)[1].float()
        ref_feats = ref_tower(eval_transform(batch[:n_ref], res, mean=mean,
                                             std=std), project=True)[1]
        cos = torch.nn.functional.cosine_similarity(feats, ref_feats, dim=-1)
        print(f"[siglip] K5+K4 features vs fp32 canonical tower ({n_ref} "
              f"images): cosine min {cos.min().item():.6f} mean "
              f"{cos.mean().item():.6f}")
        check(cos.min().item() >= COS_MIN, "SigLIP path cosine")
        ref_probs = torch.softmax(100.0 * torch.nn.functional.normalize(
            ref_feats, dim=-1) @ engine._text_weights, -1).cpu().numpy()
        agree = float((ref_probs.argmax(-1) == probs[:n_ref].argmax(-1)).mean())
        print(f"[siglip] engine top-1 vs fp32 canonical: {agree:.4f} "
              f"agreement over {n_ref}, max|dprob| "
              f"{np.abs(ref_probs - probs[:n_ref]).max():.4g}")

        # where the time goes at batch 64 (CUDA events)
        model, packed = engine.bundle.model, engine._packed
        tokens = _siglip_embed(packed, xb, cfg)
        t_pre = timed(lambda: eval_transform(batch, res, dtype=torch.bfloat16,
                                             mean=mean, std=std), 10)
        t_blocks = timed(lambda: _apply_fused_siglip_blocks(
            packed, tokens, cfg, start=0, stop=cfg.vision_layers), 3)
        t_all = timed(lambda: engine.classify(batch), 3)
    print(f"[siglip] batch 64 device time: classify {t_all:.3f} ms = "
          f"eval_transform {t_pre:.3f} + {cfg.vision_layers} blocks "
          f"{t_blocks:.3f} + patchify/MAP head/rest "
          f"{t_all - t_pre - t_blocks:.3f}")
    rate = images_per_s(engine, 64, dim, n=5)
    print(f"[siglip] classify_batch end-to-end at batch 64: {rate:.1f} "
          f"images/s")
    return counts, rate


if __name__ == "__main__":
    main()
