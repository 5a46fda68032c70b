#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aihab_clip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (any failure raises and the exit code is non-zero):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every source of ``aihab_clip_tpu_torch/csrc/`` into
     ``build/`` (one nvcc each, started together) and print nvcc's seconds
     and ptxas's register/smem report; then the launch plans of the TMA +
     wgmma kernels at the paths' shapes (registers, local bytes, shared
     bytes a block, ring stages, tiles or blocks and waves): the bf16 GEMM,
     the flash attention, K6b's dq and dk/dv kernels, the int8 GEMM;
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
     3d: the int8 kernels at SO400M shapes (``csrc/quant_kernels.cu``):
     K8 at the patchify shape, K9 (c_fc), K10 (c_proj), K13 at B=64, S=576,
     8 groups, and their pieces (row_quant, int8_gemm, the fp32-output
     attention), each against its plain version and beside
     ``torch._int_mm``; the int8 GEMM core's TOPS at the qkv, out-proj and
     c_fc shapes beside ``torch._int_mm``'s; the int8 GEMM's quantized
     output at the c_fc shape (the requantize K9 takes from its epilogue)
     against its plain version and, bit for bit, against the fp32 GEMM +
     row_quant it replaced, both timed; the normalised-P attention at head_dim
     72 (grouped), compared; then K8's LN/act/residual options and a ragged
     K13 (S=577 in a 592 pad) at small shapes, compared only;
     3e: the CLIP ViT int8 kernels at ViT-B/16 shapes (quick_gelu): K12, K11,
     K14 (mlp_chunks 1 and 2, gelu_poly, and ViT-B/32's S=50) and the pieces
     K14 adds (the residual-first c_proj GEMM, the attention at head_dim 64
     with fp32 output and P normalised before its cast, the c_fc GEMM with
     its hidden row requantized in one and in two chunks, also against the
     fp32 GEMM + row_quant bit for bit), the GEMMs beside ``torch._int_mm``;
     5c: ``ClassifierEngine("random:ViT-B/16", quantize="int8")`` answers the
     same requests: per batch 1 K8 and 12 K14, no K1; features against the
     same encode with every kernel plain and against the fp32 tower; top-1
     agreement with the bf16 engine; the ``merge_blocks="off"`` encode (12
     K12, 12 K11); the batch-64 split; images/s beside the bf16 engine's;
     6c: the ViT-B/16 PEFT step on the int8 engine's seeded weights
     (``configs/base.yaml`` + ``cs.yaml``: batch 16 at 224 from 439x439,
     unlocked_groups 11, tune_text, the default ``fused_prefix``, which
     resolves to 2 blocks): against plain kernels and the fp32 tower, 2 K1
     per step; with ``prefix_quant`` 2 K14 per step, against the bf16-prefix
     step; step times; ``finetune`` 2 steps + test;
  5. SigLIP path — ``ClassifierEngine("random:ViT-SO400M-16-SigLIP2-384",
     batch_size=64)`` answers >= 96 single 384x384 requests through
     ``DynamicBatcher``, every block through ``attn_block_split`` (K5) and
     ``mlp_block_split`` (K4); features against the fp32 canonical module
     on the card; the batch-64 device-time split; ``classify_batch``
     images/s at batch 64;
     5b: the same model with ``quantize="int8"`` (a second draw of the same
     seeded weights: the engine takes a model name, as in JAX) answers the
     same requests, per batch 1 K8, 27 K13, 27 K9, 27 K10 and no K4/K5;
     features against the same encode with every kernel plain and against
     the fp32 canonical tower; top-1 agreement with the bf16 engine; the
     batch-64 split; images/s beside the bf16 engine's;
  6. SigLIP PEFT path, on the engine's seeded SO400M weights — the default
     fine-tune (``configs/base.yaml`` + ``cs.yaml``: batch 16 at 384 from
     439x439 uint8, random crop + rotation, tune_text, unlocked_groups 11,
     unlocked_layers 1, fused prefix 17, bf16 over fp32 Adam): one train
     step against the same step with every kernel swapped for its plain
     version and against the fp32 canonical tower (loss and gradient
     gates); launches per step (17 K5, 17 K4, 10 K6 forward, 10 K6
     backward); the step's device time and its split; 6b: the same step
     with ``prefix_quant`` (17 K13, 17 K9, 17 K10, no K4/K5) against the
     bf16-prefix step (loss and gradient gate) and its time; then
     ``train.peft.finetune`` over 128 train / 16 val / 32 test images (8
     steps, val + test through ``siglip_encode_fast``), frozen leaves
     bit-identical, trained leaves moved;
     3f: K7 ``convnext_mlp_block`` and K15 ``quant_convnext_mlp_block`` at the
     four ConvNeXt base_w stage shapes (batch 64: M = 262,144 rows of C = 128
     down to 4,096 of 1,024), held against their plain versions on the
     branch out - residual; K7 with ``n_chunks=2`` at stage 3 and once per
     gelu_poly form at stage 0; the depthwise conv's ms and
     ``torch._int_mm`` at K15's GEMMs beside them;
     5d: ``ClassifierEngine("random:convnext_base_w")``, bf16 and int8 (a
     second draw of the seeded weights), answering 96 single 256x256
     requests through ``DynamicBatcher``: 36 K7 per batch, or 36 K15 and no
     K7; features against the fp32 tower and (int8) the all-plain encode;
     the features' spread; the batch-64 split (stem, per stage downsample,
     dwconv and K7 or K15, head); images/s;
     6d: the default fine-tune on the bf16 engine's ConvNeXt base_w weights
     (batch 16 at 256 from 439x439, unlocked_groups 11 -> a 26-block prefix,
     tune_text): one step against plain kernels and the fp32 tower, 26 K7
     per step, the ``prefix_quant`` step on the same bf16 prefix; step
     time; ``finetune`` 2 steps + test;
     3g: K16 (``ops/fused_linear.py``) at ViT-B/16 batch-64 shapes:
     ``ln_matmul`` at qkv and at c_fc with quick_gelu, gelu_tanh and
     gelu_poly, ``matmul_residual`` at out-proj and c_proj beside cuBLAS
     ``addmm``; K17 ``mlp_block_train`` forward and backward at M = 16 x
     197; K18 ``normalize_u8_pallas`` at 64 x 224^2 x 3, bit for bit;
     5e: path (a) on the bf16 engine's pack: uint8 -> K18 ->
     ``vit_encode_fast`` (24 ``ln_matmul`` + 24 ``matmul_residual`` per
     batch) against the all-plain run and the fp32 tower, its split
     (normalize, embed, blocks, head) and images/s beside K1's;
     6e: path (b), ``vit_encode_train`` at batch 16 on the 6c weights, every
     visual parameter trainable: 12 K17 forward and 12 backward launches,
     loss and per-parameter gradient cosine against the K17-plain step and
     the fp32 tower (``TRAIN_GATES``), fwd+bwd ms beside the canonical bf16
     module's;
     3h: the LAION towers' kernels at ViT-g/14 and ViT-bigG/14 shapes (B=64,
     S=257, 16 heads of 88 and 104): the attention in its four forms (packed
     bf16, grouped bf16 and fp32, P normalised) beside SDPA, K1, K5 + K4 and
     K13 + K9 -> K10 on JAX's routes (``JAX_ROUTES``), K14 and its c_fc
     GEMM's quantized output, and K8 at the patch-14 K = 588 (bit for bit);
     the ``[plan]`` lines of the attention instances at head_dim 64-104
     (the normalised-P instance at all four), which must not spill;
     5f: ``ClassifierEngine`` of ViT-H/14 (bf16), ViT-g/14 and ViT-bigG/14
     (bf16 and int8) at full size, the bf16 engines by their open_clip names
     (``random:ViT-bigG-14``), each answering 96 requests through
     ``DynamicBatcher``: 32/40/48 K1, or 1 K8 + 40/48 K14, per batch;
     features against the fp32 tower (and, int8, against plain kernels);
     JAX's routes for ViT-g and ViT-bigG (K5 + K4; K13 + K9 -> K10) with
     their launches and their cosine against the default route; the
     batch-64 split and images/s; each tower's load seconds; the ViT-H/14
     engine again under ``AIHAB_NO_GELU_POLY=1`` (the exact-gelu opt-out):
     96 requests, per block K2 + plain ``ln_matmul(gelu)`` + K16
     ``matmul_residual``, against plain kernels;
  7. one JSON line listing every kernel; last line ``{"ok": true, ...}``.
Each phase prints its seconds.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import statistics
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
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s
N_REQUESTS = 160
SL_REQUESTS = 96
SRC = "aihab_clip_tpu_torch/csrc/block_kernels.cu"
SRC_BWD = "aihab_clip_tpu_torch/csrc/fused_attention_bwd.cu"
SRC_Q = "aihab_clip_tpu_torch/csrc/quant_kernels.cu"
JAX_QM = "aihab_clip_tpu/ops/quant_matmul.py"
JAX_BK = "aihab_clip_tpu/ops/block_kernel.py"
JAX_ATT = "aihab_clip_tpu/ops/attention.py"
JAX_FL = "aihab_clip_tpu/ops/fused_linear.py"
JAX_PP = "aihab_clip_tpu/ops/pallas_preprocess.py"
SRC_PP = "aihab_clip_tpu_torch/csrc/preprocess.cu"
# 5f: the LAION towers (models/clip.py), full width and depth, 224 px, patch
# 14 (S = 257), exact gelu run as gelu_poly (and the ViT-H/14 engine once
# more under AIHAB_NO_GELU_POLY=1, the exact-gelu opt-out); each engine
# answers LARGE_REQUESTS single requests; the fp32 reference encodes LARGE_REF_B
# images.  JAX_ROUTES: JAX's TPU routes for them (its VMEM gates,
# fast_vit.py:410-481, quant_vit.py:165-215, 266-290): bf16 K5 over `groups`
# head groups then K4 over `chunks` hidden chunks; int8 K13 over
# `int8_groups` groups (0: K12) then the chained K9 -> K10 over
# `int8_chunks` slices (tests/test_torch_large_vit.py holds these against
# JAX's own plan and gates)
LARGE_MODELS = {"ViT-H/14": "ViT-H-14", "ViT-g/14": "ViT-g-14",
                "ViT-bigG/14": "ViT-bigG-14"}
LARGE_REQUESTS, LARGE_REF_B, LARGE_S = 96, 16, 257
LARGE_TAGS = {"ViT-H/14": "vith", "ViT-g/14": "vitg", "ViT-bigG/14": "vitbigg"}
JAX_ROUTES = {
    "ViT-H/14": dict(groups=10, chunks=4, int8_groups=0, int8_chunks=1),
    "ViT-g/14": dict(groups=8, chunks=3, int8_groups=8, int8_chunks=2),
    "ViT-bigG/14": dict(groups=8, chunks=8, int8_groups=8, int8_chunks=2)}
# path (b): vit_encode_train at the default fine-tune's batch
TRAIN_B = 16
# the default fine-tune (configs/base.yaml finetune + cs.yaml data): batch
# 16 at 384 from 439x439 uint8, lr_v 5e-5, unlocked_groups 11, text
# unlocked_layers 1 -> a frozen prefix of 27 + 1 - 11 = 17 blocks
PEFT_B, PEFT_DECODE, PEFT_LR, PEFT_UNLOCKED, PEFT_PREFIX = 16, 439, 5e-5, 11, 17
PEFT_SPLITS = (128, 16, 32)      # train (8 steps), val, test
# the same fine-tune on the offline fallback tower (configs/base.yaml:48),
# ViT-B/16 at 224: a frozen prefix of 12 + 1 - 11 = 2 blocks
VIT_PEFT_PREFIX, VIT_PEFT_SPLITS = 2, (32, 0, 16)  # train (2 steps), test
# ConvNeXt-CLIP base_w (LAION convnext_base_w, models/convnext.py
# _CONVNEXT_GRID): 256 px, stage widths 128-1024, depths (3, 3, 27, 3); the
# same fine-tune at unlocked_groups 11 freezes a prefix of 36 + 1 - 11 = 26
# blocks; 32 train images (2 steps), 16 test
CX_MODEL, CX_RES, CX_DEPTHS = "random:convnext_base_w", 256, (3, 3, 27, 3)
CX_WIDTHS, CX_REQUESTS = (128, 256, 512, 1024), 96
CX_PEFT_PREFIX, CX_PEFT_SPLITS = 26, (32, 0, 16)
# tolerances against the plain version on the same inputs, as (rel L2,
# max|d| / max|ref|): both round to bf16 at the same points, so they differ
# where an fp32 sum lands on the other side of a bf16 rounding boundary
# (1 ulp = 2^-8 relative) and through what such a flip feeds downstream
# inside a block.  Attention also rounds P to bf16 against its running
# (online) row max where the plain version uses the final row max, and
# applies 1/sum to the output rows where K5's plain version normalises P
# before its cast.  The attention backward also forms its row term as
# rowsum(dO * O) over the bf16 output, where the plain version sums dp * p
# (measured: 1.5e-3 rel L2 on dq and dk at SO400M shapes on an H100, PERF.md).
# The CLIP ViT int8 blocks: K12 and K14 within 5e-3 rel L2 (K13 measured
# 1.55e-3: the attention's 1/sum on the rows, then requantize flips), K11
# within 1e-3, which allows K9-style code flips of the LN quantize.
# K18 rounds its product and sum apart, as its plain version does: exact.
TOL = {"kernel": (2e-3, 0.02), "attention": (5e-3, 0.02),
       "attention_bwd": (5e-3, 0.02), "block": (1e-2, 0.04),
       "int8_block": (5e-3, 0.04), "int8_mlp": (1e-3, 0.04),
       "exact": (0.0, 0.0)}
COS_MIN = 0.999
# the train step: loss relative |d| and gradient cosine against the same
# step with every kernel plain (bf16), and against the fp32 canonical tower
STEP_GATES = {"plain": (1e-3, 0.999), "fp32": (1e-2, 0.99)}
# the ViT-B/16 step (2 kernel blocks, then 10 bf16 blocks under autograd):
# over 8 data draws (tools/step_spread.py on an H100, PERF.md) its loss sat
# 8.4e-5 to 2.9e-3 from the plain-kernel step, as far as from the fp32 one
# (7.5e-5 to 3.0e-3): the suffix's bf16 roundings set the loss's spread, so
# the loss limit is twice the largest reading, and the gradient cosine,
# 0.99998 against plain and 0.9995 against fp32, is the gate that tells a
# kernel's step from a differently rounded one
VIT_STEP_GATES = {"plain": (6e-3, 0.9999), "fp32": (1e-2, 0.99)}
# the int8-prefix step against the bf16-prefix step: the suffix trains on
# int8-noise features
INT8_STEP_GATE = (5e-2, 0.9)
# path (b), vit_encode_train's fwd + bwd at batch 16: loss relative |d| and
# the least per-parameter gradient cosine against the same step with K17
# plain and against the fp32 canonical tower.  Over 8 data draws
# (tools/step_spread.py --path train on an H100, PERF.md) the loss sat
# 2.0e-4 to 2.87e-3 from the K17-plain step and 2.7e-4 to 6.44e-3 from the
# fp32 one, the least cosine 0.999924 and 0.999775: the loss limit against
# plain is twice the largest reading, as VIT_STEP_GATES' (it was 1e-3, set
# from one reading of 1.6e-5; this script's own draw read 8.6e-4), the fp32
# loss limit and both cosine limits hold every reading and stay
TRAIN_GATES = {"plain": (6e-3, 0.9999), "fp32": (1e-2, 0.999)}
# int8 serving: per-image feature cosine against the same encode with every
# kernel plain (the JAX gate against its int8 reference) and against the
# fp32 canonical tower (tests/test_quant.py:66,262)
INT8_COS = {"plain": 0.995, "fp32": 0.99}
# K9's requantized codes against the plain version: equal in >= 99.9% of
# entries and never more than 1 apart (flips come from the LN's fp32
# reduction order).  Scales within 1e-6 relative in >= 99% of rows; a row
# where an input code flipped has every y moved by one code step times a
# weight, and its scale with them: those stay within 1e-3 (measured 4.3e-4
# at SO400M shapes on an H100, PERF.md)
CODES_MIN_EQUAL, SCALE_RTOL, SCALE_ROWS, SCALE_RTOL_FLIPPED = \
    0.999, 1e-6, 0.99, 1e-3


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
    t_phase = [t_start]

    def phase(name):
        now = time.perf_counter()
        print(f"[phase] {name}: {now - t_phase[0]:.1f}s")
        t_phase[0] = now

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[device] torch.cuda.get_device_name(0)={kind!r} count="
          f"{torch.cuda.device_count()} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # ---- 2. build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f}s total")
    for name, info in _build.build_info.items():
        print(f"[build] {name}: nvcc {info['seconds']}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"[build] {line.strip()}")
    kernel_plans(_build)
    phase("build")

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
        """flops: bf16 FLOPs, or (bf16 FLOPs, int8 ops)."""
        f16, i8 = flops if isinstance(flops, tuple) else (flops, 0)
        t_ops = f16 / PEAK_FLOPS + i8 / PEAK_INT8_OPS
        t_bytes = nbytes / PEAK_BYTES
        return (1e3 * max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def compare_codes(name, out, ref):
        """K9's (codes, scales) against the plain version's."""
        torch.cuda.synchronize()
        d = (out[0].int() - ref[0].int()).abs()
        equal = (d == 0).float().mean().item()
        rel_rows = ((out[1] - ref[1]).abs() / ref[1].abs()).flatten()
        srel = rel_rows.max().item()
        rows_ok = (rel_rows <= SCALE_RTOL).float().mean().item()
        print(f"[kernels] {name}: codes equal {equal:.6f} (limit "
              f"{CODES_MIN_EQUAL}), max|d| {d.max().item()} (limit 1); scales "
              f"within {SCALE_RTOL:g} rel in {rows_ok:.6f} of rows (limit "
              f"{SCALE_ROWS}), max rel {srel:.3e} (limit "
              f"{SCALE_RTOL_FLIPPED:g})")
        check(bool(torch.isfinite(out[1]).all()), f"{name}: non-finite scales")
        check(d.max().item() <= 1 and equal >= CODES_MIN_EQUAL
              and rows_ok >= SCALE_ROWS and srel <= SCALE_RTOL_FLIPPED,
              f"{name} disagrees with its plain version (equal {equal}, "
              f"scale rows {rows_ok}, max rel {srel})")
        return float(d.max().item()), 1.0 - equal, 1.0

    rows = []

    def run_cases(cases):
        """Each case: (name, replaces, tolerance kind, kernel fn, plain fn,
        library fn or None, flops, bytes, launch counter, path[, source]).
        A tolerance kind (kind, residual) compares the branch out - residual
        of both versions.  Returns the rows it adds."""
        added = []
        for (name, replaces, kind_, fn, plain, lib, flops, nbytes, counter,
             path, *src) in cases:
            if kind_ == "codes":
                err, rel, lim = compare_codes(name, fn(), plain())
                tol_rel = 1.0 - CODES_MIN_EQUAL
            elif isinstance(kind_, tuple):
                kind_, res = kind_
                err, rel, lim = compare(f"{name} branch", fn().float() - res,
                                        plain().float() - res, kind_)
                tol_rel = TOL[kind_][0]
            else:
                err, rel, lim = compare(name, fn(), plain(), kind_)
                tol_rel = TOL[kind_][0]
            ms, plain_ms = timed(fn), timed(plain, iters=5)
            lib_ms = timed(lib) if lib is not None else None
            b_ms, b_by = bound(flops, nbytes)
            ops = sum(flops) if isinstance(flops, tuple) else flops
            print(f"[kernels] {name}: {ms:.4f} ms (plain {plain_ms:.4f}, "
                  f"library {lib_ms if lib_ms is None else round(lib_ms, 4)}, "
                  f"bound {b_ms:.4f} by {b_by}; {ops / ms / 1e9:.1f} "
                  f"T(FL)OP/s)")
            rows.append(dict(name=name, route="cuda",
                             source=src[0] if src else SRC,
                             replaces=replaces, launches=None,
                             counter=counter, path=path, max_abs_err=err,
                             tol_max_abs=lim, rel_l2=rel,
                             tol_rel_l2=tol_rel, ms=ms,
                             tflops=ops / ms / 1e9, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
            added.append(rows[-1])
            torch.cuda.empty_cache()
        return added

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

    # ---- 3c. fused attention (K6) forward and backward, SigLIP PEFT shapes
    fused_attention_cases(rnd, run_cases, compare, timed)

    # ---- 3d. the int8 kernels (K8, K9, K10, K13) at SO400M shapes
    int8_core = int8_kernel_cases(rnd, vec, run_cases, compare, timed)

    # ---- 3e. the CLIP ViT int8 kernels (K12, K11, K14) at ViT-B/16 shapes
    int8_core.update(vit_int8_kernel_cases(rnd, vec, run_cases, timed))

    # ---- 3f. K7 and K15 at the four ConvNeXt base_w stage shapes
    convnext_kernel_cases(rnd, vec, run_cases, compare, timed)

    # ---- 3g. K16 at ViT-B/16 shapes, K17 at the train batch, K18
    vit_fast_kernel_cases(rnd, vec, run_cases, compare)

    # ---- 3h. the LAION towers' kernels at ViT-g/14 and ViT-bigG/14 shapes
    large_vit_kernel_cases(rnd, vec, run_cases)
    phase("kernels")

    # ---- 4. the ViT path: engine + dynamic batcher
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.models.fast_vit import (encode_image_fastest,
                                                     vit_encode_block_fused)
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    engine = ClassifierEngine(model="random:ViT-B/16", batch_size=64,
                              device="cuda")
    engine.warmup()
    print(f"[path] engine built + warm in {time.perf_counter() - t_phase[0]:.1f}s")
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

    # where the time goes at batch 64 (CUDA events, stages of one run)
    split, t_all = classify_split(engine, batch, [
        ("encode", lambda x: encode_image_fastest(
            engine.bundle.model, x, cfg, project=True,
            packed=engine._packed)[1])])
    print(f"[path] batch 64 device time: classify {t_all:.3f} ms; its stages "
          f"in one run {sum(split.values()):.3f} = eval_transform "
          f"{split['eval_transform']:.3f} + encode {split['encode']:.3f} + "
          f"head {split['head']:.3f}")

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
    del batch, xb
    torch.cuda.empty_cache()
    phase("vit path")

    # ---- 5e. path (a): uint8 -> K18 -> vit_encode_fast (K16)
    counts["vit_fast"], fast_rates, fast_figures = vit_fast_path(engine,
                                                                 images)
    rates.update(fast_rates)
    del engine
    torch.cuda.empty_cache()
    phase("vit fast path")

    # ---- 5c. the int8 ViT-B/16 path: engine + dynamic batcher
    (counts["vit_int8"], counts["vit_int8_off"], rates["vit_b16_int8_64"],
     vit_int8_figures, engine) = vit_int8_path(bk, images, probs,
                                               rates["vit_b16_64"])
    phase("vit int8 path")

    # ---- 6c. the ViT-B/16 PEFT path on the int8 engine's weights
    vit_train = vit_peft_path(engine.bundle.model, bk)
    phase("vit peft path")

    # ---- 6e. path (b): vit_encode_train (K17) on the same weights
    counts["vit_train"], fast_train = vit_train_path(engine.bundle.model)
    del engine
    torch.cuda.empty_cache()
    phase("vit train path")

    # ---- 5. the SigLIP path: engine + dynamic batcher
    counts["siglip"], rates["siglip_so400m_64"], engine = siglip_path(bk)
    phase("siglip path")

    # ---- 5b. the int8 SigLIP path: engine + dynamic batcher
    counts["siglip_int8"], rates["siglip_so400m_int8_64"], int8_figures = \
        siglip_int8_path(bk, engine, rates["siglip_so400m_64"])
    phase("siglip int8 path")

    # ---- 6. the SigLIP PEFT path on the engine's weights
    counts["siglip_peft"], train = peft_path(engine, bk)
    del engine
    torch.cuda.empty_cache()
    phase("peft path")

    # ---- 5d. the ConvNeXt base_w bf16 and int8 engines + dynamic batcher
    cx_counts, cx_rates, cx_figures, engine = convnext_path(bk)
    counts.update(cx_counts)
    rates.update(cx_rates)
    phase("convnext paths")

    # ---- 6d. the ConvNeXt base_w PEFT step and finetune on its weights
    cx_train = convnext_peft_path(engine.bundle.model, bk)
    del engine
    torch.cuda.empty_cache()
    phase("convnext peft path")

    # ---- 5f. the LAION ViT-H/14, ViT-g/14 and ViT-bigG/14 engines
    large_counts, large_rates, large_figures = large_vit_paths(bk)
    counts.update(large_counts)
    rates.update(large_rates)
    phase("large vit paths")

    # ---- 7. kernels line + result
    names = {"vit": "ViT-B/16 engine + DynamicBatcher",
             "vit_off": "ViT-B/16 merge_blocks='off' encode",
             "vit_int8": "ViT-B/16 int8 engine + DynamicBatcher",
             "vit_int8_off": "ViT-B/16 int8 merge_blocks='off' encode",
             "siglip": "SigLIP SO400M engine + DynamicBatcher",
             "siglip_int8": "SigLIP SO400M int8 engine + DynamicBatcher",
             "siglip_peft": f"SigLIP SO400M finetune ({PEFT_SPLITS[0] // PEFT_B}"
                            " steps + val/test)",
             "convnext": "ConvNeXt base_w engine + DynamicBatcher",
             "convnext_int8": "ConvNeXt base_w int8 engine + DynamicBatcher",
             "vit_fast": "ViT-B/16 uint8 -> normalize_u8 -> vit_encode_fast",
             "vit_train": f"ViT-B/16 vit_encode_train step (batch {TRAIN_B})"}
    for arch, tag in LARGE_TAGS.items():
        names.update({tag: f"{arch} engine + DynamicBatcher",
                      tag + "_jax": f"{arch} JAX's route (K5 + K4) encode",
                      tag + "_int8": f"{arch} int8 engine + DynamicBatcher",
                      tag + "_int8_jax": f"{arch} JAX's int8 route (K13 + "
                                         "K9 -> K10) encode"})
    for row in rows:
        counter = row.pop("counter").__name__
        row["launches"] = counts[row["path"]][counter]
        row["path"] = names[row["path"]]
        check(row["launches"] > 0, f"{row['name']} never launched on its path")
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": rows, "card": smi, "images_per_s": rates,
                      "int8": int8_figures, "vit_int8": vit_int8_figures,
                      "convnext": cx_figures, "train": train,
                      "vit_train": vit_train, "convnext_train": cx_train,
                      "vit_fast": fast_figures,
                      "vit_encode_train": fast_train, "int8_core": int8_core,
                      "large_vit": large_figures}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def kernel_plans(build) -> None:
    """Registers, local bytes, shared bytes a block and grid (tiles, waves)
    of the TMA + wgmma GEMM and flash attention at the paths' shapes."""
    import ctypes

    import torch

    lib = build.library()
    out = (ctypes.c_int * 6)()
    gemms = {"ViT-B/16 qkv": (B * S, 3 * W, 0), "c_fc": (B * S, HIDDEN, 0),
             "out-proj": (B * S, W, 1), "c_proj": (B * S, W, 1),
             "SO400M c_fc chunk": (B * SL_S, SL_HIDDEN // SL_CHUNKS, 0),
             "K17 c_fc (M = 16 x 197)": (TRAIN_B * S, HIDDEN, 0),
             "ConvNeXt stage 0 fc1": (B * 64 * 64, 512, 0),
             "ConvNeXt stage 3 fc2": (B * 8 * 8, 1024, 1),
             "ViT-bigG/14 qkv": (B * LARGE_S, 3 * 1664, 0),
             "ViT-bigG/14 c_fc": (B * LARGE_S, 8192, 0),
             "ViT-bigG/14 c_proj": (B * LARGE_S, 1664, 1)}
    for label, (m, n, res) in gemms.items():
        check(lib.aihab_gemm_plan(m, n, res, out) == 0, "gemm plan")
        print(f"[plan] gemm_kernel {label} [{m} x {n}]: {out[4]} registers, "
              f"{out[5]} local bytes, {out[1]} shared bytes/block, ring of "
              f"{out[0]} stages, {out[2]} tiles on {out[3]} blocks "
              f"({out[2] / out[3]:.2f} waves)")
    for label, (b, s, heads, d) in {
            "ViT-B/16": (B, S, HEADS, W // HEADS),
            "SO400M": (B, SL_S, SL_HEADS, SL_W // SL_HEADS),
            "K6f (B = 16)": (PEFT_B, SL_S, SL_HEADS, SL_W // SL_HEADS)}.items():
        check(lib.aihab_flash_plan(b, s, heads, d, 0, out) == 0, "flash plan")
        print(f"[plan] flash_attention_kernel<{d}> {label}: {out[4]} "
              f"registers, {out[5]} local bytes, {out[1]} shared bytes/block, "
              f"{out[2]} blocks of 128 threads")
    # the instances at ViT-g/14's and ViT-bigG/14's head widths (B = 64, S =
    # 257, 16 heads): the flash kernel with bf16 and fp32 output, and its
    # normalised-P instance (NORM_P), which also runs at D 64 (K14 at
    # ViT-B/16) and is built at D 72
    for b, s, heads, d in ((B, S, HEADS, W // HEADS), (B, SL_S, SL_HEADS, 72),
                           (B, LARGE_S, 16, 88), (B, LARGE_S, 16, 104)):
        kinds = ((2, "flash_attention_kernel<{}, float, NORM_P>"),)
        if d in (88, 104):
            kinds = ((0, "flash_attention_kernel<{}, bf16>"),
                     (1, "flash_attention_kernel<{}, float>")) + kinds
        for kind, label in kinds:
            check(lib.aihab_flash_plan(b, s, heads, d, kind, out) == 0,
                  "attention plan")
            print(f"[plan] {label.format(d)} (B = {b}, S = {s}, {heads} "
                  f"heads): {out[4]} registers, {out[5]} local bytes, "
                  f"{out[1]} shared bytes/block, {out[2]} blocks of 128 "
                  f"threads")
            check(out[5] == 0, f"{label.format(d)} spills")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bwd = (ctypes.c_int * 12)()
    for s in (SL_S, SL_S + 1):
        check(build.library("fused_attention_bwd").aihab_fused_attention_bwd_plan(
            PEFT_B, s, SL_HEADS, SL_W // SL_HEADS, bwd) == 0, "K6b plan")
        for i, name in enumerate(("dq", "dk/dv")):
            o = bwd[6 * i:6 * i + 6]
            print(f"[plan] K6b {name} kernel (B = {PEFT_B}, S = {s}, "
                  f"{SL_HEADS}x{SL_W // SL_HEADS}): {o[4]} registers, {o[5]} "
                  f"local bytes, {o[1]} shared bytes/block, ring of {o[0]} "
                  f"stages, {o[2]} blocks of 128 threads, {o[3]} an SM "
                  f"({o[2] / (o[3] * sms):.2f} waves)")
    q8 = (ctypes.c_int * 8)()
    m_sl = B * SL_S
    for label, (m, n, k, groups, res) in {
            "SO400M qkv": (m_sl, 3 * SL_W, SL_W, 1, 0),
            "SO400M out-proj, 8 groups of 144 padded to 160":
                (m_sl, SL_W, SL_GROUPS * 160, SL_GROUPS, 1),
            "SO400M c_fc": (m_sl, SL_HIDDEN, SL_W, 1, 0),
            "SO400M c_proj + x": (m_sl, SL_W, SL_HIDDEN, 1, 1),
            "ViT-B/16 qkv": (B * S, 3 * W, W, 1, 0),
            "ConvNeXt stage 0 fc1": (B * 64 * 64, 512, 128, 1, 0),
            "ViT-bigG/14 patch 14, K 588 in 592": (B * 256, 1664, 592, 1, 0),
            "ViT-g/14 out-proj, 8 groups of 176 padded to 192":
                (B * LARGE_S, 1408, 8 * 192, 8, 1),
            "ViT-bigG/14 out-proj, 8 groups of 208 padded to 224":
                (B * LARGE_S, 1664, 8 * 224, 8, 1),
            "ViT-bigG/14 c_fc": (B * LARGE_S, 8192, 1664, 1, 0),
            "SO400M c_fc, quantized output": (m_sl, SL_HIDDEN, SL_W, 1, 2),
            "ViT-B/16 c_fc, quantized output": (B * S, HIDDEN, W, 1, 2)}.items():
        check(build.library("quant_kernels").aihab_int8_gemm_plan(
            m, n, k, groups, res, q8) == 0, "int8 plan")
        print(f"[plan] int8_gemm_kernel {label} [{m} x {n}, K {k}]: {q8[4]} "
              f"registers, {q8[5]} local bytes, {q8[1]} shared bytes/block, "
              f"ring of {q8[0]} stages, {q8[2]} tiles on {q8[3]} blocks "
              f"({q8[2] / q8[3]:.2f} waves), {q8[6]} k-steps a tile "
              f"({q8[7]} of 32 bytes)")



def vit_fast_kernel_cases(rnd, vec, run_cases, compare) -> None:
    """3g. K16 at ViT-B/16 batch-64 shapes (``ln_matmul`` at qkv and at c_fc
    with each kernel activation, ``matmul_residual`` at out-proj and c_proj,
    beside cuBLAS ``addmm`` with the residual as its input), K17's forward
    and backward at the train batch (M = 16 x 197) on the branches y - x and
    dx - dy, with h_pre, dh_pre and dln compared too, and K18 at 64 x 224^2
    x 3, bit for bit; each against its plain version."""
    import torch

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import fused_linear as fl
    from aihab_clip_tpu_torch.ops import pallas_preprocess as pp

    m, mt = B * S, TRAIN_B * S
    x2, attn = rnd(m, W), rnd(m, W)
    ln = (vec(W, one=True), vec(W))
    w_qkv, b_qkv = rnd(W, 3 * W, scale=W ** -0.5), vec(3 * W)
    w_out, b_out = rnd(W, W, scale=W ** -0.5), vec(W)
    w_fc, b_fc = rnd(W, HIDDEN, scale=W ** -0.5), vec(HIDDEN)
    w_proj, b_proj = rnd(HIDDEN, W, scale=HIDDEN ** -0.5), vec(W)
    h = fl.ln_matmul(x2, *ln, w_fc, b_fc, "quick_gelu")
    b_fc_bytes = 2 * m * W + 2 * W * HIDDEN + 2 * m * HIDDEN
    cases = [("ln_matmul[qkv]", f"{JAX_FL}:299", "kernel",
              lambda: fl.ln_matmul(x2, *ln, w_qkv, b_qkv),
              lambda: fl.ln_matmul_plain(x2, *ln, w_qkv, b_qkv), None,
              2 * m * W * 3 * W, 2 * m * W + 2 * W * 3 * W + 2 * m * 3 * W,
              fl.ln_matmul, "vit_fast")]
    for act in ("quick_gelu", "gelu_tanh", "gelu_poly"):
        cases.append((
            f"ln_matmul[c_fc, {act}]", f"{JAX_FL}:299", "kernel",
            lambda act=act: fl.ln_matmul(x2, *ln, w_fc, b_fc, act),
            lambda act=act: fl.ln_matmul_plain(x2, *ln, w_fc, b_fc, act),
            None, 2 * m * W * HIDDEN, b_fc_bytes, fl.ln_matmul, "vit_fast"))
    cases += [
        ("matmul_residual[out_proj]", f"{JAX_FL}:326", "kernel",
         lambda: fl.matmul_residual(attn, w_out, b_out, x2),
         lambda: fl.matmul_residual_plain(attn, w_out, b_out, x2),
         lambda: torch.addmm(x2, attn, w_out), 2 * m * W * W,
         6 * m * W + 2 * W * W, fl.matmul_residual, "vit_fast"),
        ("matmul_residual[c_proj]", f"{JAX_FL}:326", "kernel",
         lambda: fl.matmul_residual(h, w_proj, b_proj, x2),
         lambda: fl.matmul_residual_plain(h, w_proj, b_proj, x2),
         lambda: torch.addmm(x2, h, w_proj), 2 * m * HIDDEN * W,
         2 * m * HIDDEN + 2 * HIDDEN * W + 4 * m * W, fl.matmul_residual,
         "vit_fast")]

    xt, dy = rnd(mt, W), rnd(mt, W)
    targs = (xt, vec(W, one=True), vec(W), w_fc, b_fc, w_proj, b_proj)
    _, hp = bk.mlp_block_train_fwd_plain(*targs)
    bargs = (xt, hp, dy, targs[1], w_fc, w_proj)
    f_k17, w_pair = 4 * mt * W * HIDDEN, 2 * 2 * W * HIDDEN
    cases += [
        ("mlp_block_train[fwd]", f"{JAX_BK}:239", ("block", xt),
         lambda: bk.mlp_block_train_fwd(*targs)[0],
         lambda: bk.mlp_block_train_fwd_plain(*targs)[0], None, f_k17,
         4 * mt * W + 2 * mt * HIDDEN + w_pair, bk.mlp_block_train_fwd,
         "vit_train"),
        ("mlp_block_train[bwd]", f"{JAX_BK}:287", ("block", dy),
         lambda: bk.mlp_block_train_bwd(*bargs)[0],
         lambda: bk.mlp_block_train_bwd_plain(*bargs)[0], None, f_k17,
         8 * mt * W + 4 * mt * HIDDEN + w_pair, bk.mlp_block_train_bwd,
         "vit_train")]

    u8 = torch.randint(0, 256, (B, 224, 224, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(SEED + 8)
                       ).to(x2.device)
    cases.append(("normalize_u8_pallas", f"{JAX_PP}:79", "exact",
                  lambda: pp.normalize_u8_pallas(u8),
                  lambda: pp.normalize_u8_pallas_plain(u8), None, 0,
                  3 * u8.numel(), pp.normalize_u8_pallas, "vit_fast", SRC_PP))
    run_cases(cases)
    compare("mlp_block_train[fwd] h_pre", bk.mlp_block_train_fwd(*targs)[1],
            hp, "kernel")
    for name, got, ref in zip(("dh_pre", "dln"),
                              bk.mlp_block_train_bwd(*bargs)[1:],
                              bk.mlp_block_train_bwd_plain(*bargs)[1:]):
        compare(f"mlp_block_train[bwd] {name}", got, ref, "kernel")


def vit_fast_path(engine, images):
    """5e. Path (a) on the bf16 ViT-B/16 engine's pack: uint8 [64, 224, 224,
    3] -> ``normalize_u8(use_pallas=True)`` (K18) -> ``vit_encode_fast`` (24
    ``ln_matmul`` + 24 ``matmul_residual``) -> ``ln_post(CLS)`` -> ``proj``;
    features against the all-plain run and the fp32 canonical tower on the
    same normalization in fp32; K18 bit for bit; the batch's split and
    images/s (CUDA events) beside the K1 encode's.  Returns (path (a)'s
    launches, images/s, figures)."""
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import fused_linear as fl
    from aihab_clip_tpu_torch.ops import pallas_preprocess as pp

    dev = torch.device("cuda")
    cfg, packed, model = engine.bundle.config, engine._packed, \
        engine.bundle.model
    u8 = torch.from_numpy(images[:B]).to(dev)
    cos = torch.nn.functional.cosine_similarity

    def counts():
        return {**bk.launch_counts(), **fl.launch_counts(),
                **pp.launch_counts()}

    def reset():
        for mod in (bk, fl, pp):
            mod.reset_launch_counts()

    def encode(u):
        return fast_vit.vit_encode_fast(packed, pp.normalize_u8(
            u, use_pallas=True), cfg, project=True)[1]

    figures = {}
    with torch.inference_mode():
        reset()
        feats = encode(u8).float()
        torch.cuda.synchronize()
        run = counts()
        print(f"[vit fast] launches in one batch: {run}")
        check(run["normalize_u8_pallas"] == 1 and run["ln_matmul"] == 24
              and run["matmul_residual"] == 24 and run["ln_gemm"] == 24
              and run["gemm_residual"] == 24 and run["full_block_fused"] == 0,
              "path (a) launches per batch")
        x = pp.normalize_u8(u8, use_pallas=True)
        check(torch.equal(x, pp.normalize_u8_pallas_plain(u8)),
              "K18 is not bit for bit its plain version")
        with mock.patch.multiple(fast_vit, ln_matmul=fl.ln_matmul_plain,
                                 matmul_residual=fl.matmul_residual_plain):
            plain = fast_vit.vit_encode_fast(
                packed, pp.normalize_u8_pallas_plain(u8), cfg,
                project=True)[1].float()
        vis_dt = model.visual.dtype
        model.visual.dtype = torch.float32
        try:
            ref = model.encode_image(pp.normalize_u8_pallas_plain(
                u8, dtype=torch.float32), project=True)[1]
        finally:
            model.visual.dtype = vis_dt
        c_plain, c_ref = cos(feats, plain, dim=-1), cos(feats, ref, dim=-1)
        print(f"[vit fast] features vs all-plain run: cosine min "
              f"{c_plain.min().item():.6f}; vs fp32 canonical tower: min "
              f"{c_ref.min().item():.6f} mean {c_ref.mean().item():.6f}")
        check(c_plain.min().item() >= COS_MIN, "path (a) vs all-plain")
        check(c_ref.min().item() >= COS_MIN, "path (a) vs fp32")
        figures.update(cos_plain_min=c_plain.min().item(),
                       cos_fp32_min=c_ref.min().item(), k18_exact=True)

        def head(t):
            return fast_vit._ln(t[:, 0, :], *packed["ln_post"]) \
                @ packed["proj"]

        split, y = staged_ms(u8, [
            ("normalize", lambda u: pp.normalize_u8(u, use_pallas=True)),
            ("embed", lambda t: fast_vit._vit_embed(packed, t, cfg)),
            ("blocks", lambda t: fast_vit._per_op_blocks(packed, t, cfg)),
            ("head", head)])
        check(torch.equal(y.float(), feats), "the staged run differs")
        whole = {**staged_ms(u8, [("fast", encode)])[0],
                 **staged_ms(u8, [("k1", lambda u: (
                     fast_vit.vit_encode_block_fused(packed, pp.normalize_u8(
                         u, use_pallas=True), cfg, project=True)[1]))])[0]}
        rate = 1e3 * B / whole["fast"]
        print(f"[vit fast] batch {B} device time, uint8 -> features: "
              f"{whole['fast']:.3f} ms ({rate:.1f} images/s); its stages "
              f"{sum(split.values()):.3f} = normalize "
              f"{split['normalize']:.3f} + embed {split['embed']:.3f} + "
              f"blocks {split['blocks']:.3f} + head {split['head']:.3f}; "
              f"the same from K18 through K1: {whole['k1']:.3f} ms")
        figures.update(split_ms=split, encode_ms=whole["fast"],
                       k1_encode_ms=whole["k1"])

    return run, {"vit_b16_fast_64": rate}, figures


def vit_train_path(model):
    """6e. Path (b): ``vit_encode_train`` on ViT-B/16 at batch 16, every
    visual parameter trainable: one forward and one backward of a
    projected-feature loss (cross-entropy of 100 x cosine logits against a
    random 20-class head) through 12 blocks, the attention half under
    autograd and the MLP half through K17 (12 + 12 launches); loss and
    per-parameter gradient cosine against the same step with K17 plain and
    against the fp32 canonical tower (``TRAIN_GATES``); its fwd+bwd ms
    beside the canonical bf16 module's.  Returns (its launches, figures)."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops.preprocess import normalize

    dev = torch.device("cuda")
    cfg = model.config
    rng = np.random.default_rng(SEED + 5)
    u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_B, 224, 224, 3),
                                       dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 20, TRAIN_B)).to(dev)
    tw = F.normalize(torch.from_numpy(rng.standard_normal(
        (cfg.embed_dim, 20)).astype(np.float32)), dim=0).to(dev)
    x32 = normalize(u8, dtype=torch.float32)
    xb = x32.to(torch.bfloat16)
    params = list(model.visual.named_parameters())
    for _, p in params:
        p.requires_grad_(True)

    def loss_of(f):
        return F.cross_entropy(100.0 * F.normalize(f.float(), dim=-1) @ tw,
                               labels)

    def fast():
        return fast_vit.vit_encode_train(model, xb, cfg, project=True)[1]

    def canonical():
        return model.encode_image(xb, project=True)[1]

    def step(encode):
        model.zero_grad(set_to_none=True)
        loss = loss_of(encode())
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), [p.grad.float().flatten() for _, p in params]

    bk.reset_launch_counts()
    kern = step(fast)
    run = bk.launch_counts()
    print(f"[vit train] launches in one fwd+bwd: {run}")
    check(run["mlp_block_train_fwd"] == 12 and run["mlp_block_train_bwd"] == 12,
          "K17 launches per step")
    with mock.patch.object(fast_vit, "mlp_block_train",
                           bk.mlp_block_train_plain):
        bk.reset_launch_counts()
        plain = step(fast)
        check(not any(bk.launch_counts().values()), "plain step launched")
    vis_dt = model.visual.dtype
    model.visual.dtype = torch.float32
    try:
        fp32 = step(lambda: model.encode_image(x32, project=True)[1])
    finally:
        model.visual.dtype = vis_dt
    figures = {}
    for name, ref in (("plain", plain), ("fp32", fp32)):
        rel = abs(kern[0] - ref[0]) / abs(ref[0])
        per = torch.stack([F.cosine_similarity(a, b, dim=0)
                           for a, b in zip(kern[1], ref[1])])
        worst = params[int(per.argmin())][0]
        whole = F.cosine_similarity(torch.cat(kern[1]), torch.cat(ref[1]),
                                    dim=0).item()
        lim_rel, lim_cos = TRAIN_GATES[name]
        print(f"[vit train] vs {name}: loss {kern[0]:.6f} vs {ref[0]:.6f}, "
              f"rel |d| {rel:.3e} (limit {lim_rel:g}); per-parameter "
              f"gradient cosine min {per.min().item():.6f} at {worst} (limit "
              f"{lim_cos:g}), whole {whole:.6f}")
        check(rel <= lim_rel and per.min().item() >= lim_cos,
              f"vit_encode_train step vs {name}")
        figures[name] = dict(loss_rel=rel, grad_cos_min=per.min().item(),
                             grad_cos=whole)

    times = {"vit_encode_train": [], "canonical": []}
    for _ in range(2):
        for label, encode in (("vit_encode_train", fast),
                              ("canonical", canonical)):
            for i in range(4):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                model.zero_grad(set_to_none=True)
                e0.record()
                loss_of(encode()).backward()
                e1.record()
                torch.cuda.synchronize()
                if i >= 1:
                    times[label].append(e0.elapsed_time(e1))
    model.zero_grad(set_to_none=True)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"[vit train] fwd+bwd at batch {TRAIN_B}, median of "
          f"{len(times['canonical'])} in two turns: vit_encode_train "
          f"{med['vit_encode_train']:.3f} ms, canonical bf16 module "
          f"{med['canonical']:.3f} ms")
    figures.update(step_ms=med, step_ms_all=times)
    return run, figures


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


def staged_ms(x, stages, iters=5):
    """CUDA-event ms of each stage of one chained run (each stage takes the
    previous stage's output), the median over ``iters`` runs after one
    warm-up run, stages of one name summed within a run; returns ({stage:
    ms}, the last run's output).  The stages of a run are timed in that run,
    so their sum is its time."""
    import torch

    runs = []
    for i in range(iters + 1):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
        y = x
        events[0].record()
        for event, (_, fn) in zip(events[1:], stages):
            y = fn(y)
            event.record()
        torch.cuda.synchronize()
        if i:
            run = {}
            for (name, _), a, b in zip(stages, events, events[1:]):
                run[name] = run.get(name, 0.0) + a.elapsed_time(b)
            runs.append(run)
    return {name: statistics.median(r[name] for r in runs)
            for name in runs[0]}, y


def classify_split(engine, batch, stages, iters=5):
    """``engine.classify(batch)`` as timed stages: ``stages`` from the
    normalised images to the features, then classify's own head (L2
    normalise, cosine logits against the text head, softmax); checks the
    chain gives classify's probabilities.  Returns ({stage: ms}, classify
    ms on its own, timed the same way)."""
    import torch

    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)

    mean, std = normalize_stats_for(engine.bundle.config)

    def head(feats):
        f = feats.float()
        f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.softmax(100.0 * f @ engine._text_weights, dim=-1)

    with torch.inference_mode():
        split, probs = staged_ms(batch, [
            ("eval_transform", lambda b: eval_transform(
                b, engine.resolution, dtype=torch.bfloat16, mean=mean,
                std=std)),
            *stages, ("head", head)], iters)
        total, ref = staged_ms(batch, [("classify", engine.classify)], iters)
    err = (probs - ref).abs().max().item()
    check(err <= 1e-6, f"the timed stages differ from classify by {err:.3g}")
    return split, total["classify"]


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


def int8_kernel_cases(rnd, vec, run_cases, compare, timed) -> dict:
    """The int8 SigLIP path's kernels at SO400M shapes, batch 64: K8 at the
    patchify shape (no LN, act or residual), K9 (LN2 + c_fc + gelu_tanh +
    requantize), K10 (c_proj + bias + residual), K13 (8 groups of 2 heads of
    72) and their pieces, each timed beside ``torch._int_mm`` at its GEMM's
    shape (the GEMM core only; K13 has no one-call counterpart); the int8
    GEMM core alone at the qkv, out-proj and c_fc shapes beside
    ``torch._int_mm``; then K8's options and a ragged K13 at small shapes,
    compared only.  Returns the core's figures."""
    import math

    import torch

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    b, s, w, heads, hid = B, SL_S, SL_W, SL_HEADS, SL_HIDDEN
    d, groups = w // heads, SL_GROUPS
    gd, kp = w // groups, qm._group_pad(w // groups)
    m, kpatch = b * s, 16 * 16 * 3

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5,
                                     dtype=torch.float32))
        return qm.int8_weight(w8), ws

    x = rnd(b, s, w)
    x2 = x.reshape(m, w)
    patches = rnd(m, kpatch)
    ln1, ln2 = (vec(w, one=True), vec(w)), (vec(w, one=True), vec(w))
    wp8, sp = weight(kpatch, w)
    wf8, sf = weight(w, hid)
    wc8, sc = weight(hid, w)
    bp, bf, bc, bo = vec(w), vec(hid), vec(w), vec(w)
    wq8, sq = quantize_weight(rnd(w, 3 * w, scale=w ** -0.5,
                                  dtype=torch.float32))
    wo8, so = quantize_weight(rnd(w, w, scale=w ** -0.5, dtype=torch.float32))
    wg, sg, bg, og = qm.regroup_attn_weights(wq8, sq, vec(3 * w), wo8, heads,
                                             groups)
    wg, og = qm.int8_attn_weights(wg, og)
    k13 = (wg, sg, bg, og, so, bo, *ln1, heads, groups)
    h8, hs = qm.quant_matmul_fused_qout(x2, wf8, sf, bf, *ln2,
                                        act="gelu_tanh", ln_eps=1e-6)
    # the pieces' inputs, as the compositions make them
    x8, sx = qm.row_quant(x2, *ln1, eps=1e-6)
    y = qm.int8_gemm(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                     out_dtype=torch.float32)
    qkv = qm.int8_gemm(x8, sx, qm._qkv_operand(wg), sg.reshape(-1),
                       bg.reshape(-1), q_scale=1.0 / math.sqrt(d),
                       q_width=gd).reshape(b, s, 3 * w)
    attn = bk.attention(qkv, heads, group_heads=heads // groups,
                        q_scaled=True, out_dtype=torch.float32)
    a8, sa = qm.row_quant(attn.reshape(m, w), group=gd, group_pad=kp)
    wout = qm._out_operand(og)
    # torch._int_mm yardsticks at each GEMM's shape, int32 out
    mm_in = {kk: torch.randint(-127, 128, (m, kk), dtype=torch.int8,
                               device=x.device) for kk in (kpatch, w, hid)}
    int_mm = torch._int_mm
    f_patch, f_fc = 2 * m * kpatch * w, 2 * m * w * hid
    f_qkv, f_out = 2 * m * w * 3 * w, 2 * m * w * w
    f_att = 4 * b * heads * s * s * d
    print(f"[kernels] int8 at SO400M shapes: B={b} S={s} W={w} {heads}x{d} "
          f"hidden {hid}, {groups} groups of {gd} columns (padded to {kp})")
    run_cases([
        ("quant_matmul_fused[patchify]", f"{JAX_QM}:376", "kernel",
         lambda: qm.quant_matmul_fused(patches, wp8, sp, bp),
         lambda: qm.quant_matmul_fused_plain(patches, wp8, sp, bp),
         lambda: int_mm(mm_in[kpatch], wp8), (0, f_patch),
         2 * m * kpatch + kpatch * w + 8 * w + 2 * m * w,
         qm.quant_matmul_fused, "siglip_int8", SRC_Q),
        ("quant_matmul_fused_qout[c_fc]", f"{JAX_QM}:130", "codes",
         lambda: qm.quant_matmul_fused_qout(x2, wf8, sf, bf, *ln2,
                                            act="gelu_tanh", ln_eps=1e-6),
         lambda: qm.quant_matmul_fused_qout_plain(x2, wf8, sf, bf, *ln2,
                                                  act="gelu_tanh",
                                                  ln_eps=1e-6),
         lambda: int_mm(mm_in[w], wf8), (0, f_fc),
         2 * m * w + w * hid + 8 * (w + hid) + m * hid + 4 * m,
         qm.quant_matmul_fused_qout, "siglip_int8", SRC_Q),
        ("quant_matmul_q8in[c_proj]", f"{JAX_QM}:165", "kernel",
         lambda: qm.quant_matmul_q8in(h8, hs, wc8, sc, bc, x2),
         lambda: qm.quant_matmul_q8in_plain(h8, hs, wc8, sc, bc, x2),
         lambda: int_mm(mm_in[hid], wc8), (0, f_fc),
         m * hid + 4 * m + hid * w + 8 * w + 2 * m * w + 2 * m * w,
         qm.quant_matmul_q8in, "siglip_int8", SRC_Q),
        ("quant_attn_block_split", f"{JAX_QM}:622", "block",
         lambda: qm.quant_attn_block_split(x, *k13, ln_eps=1e-6),
         lambda: qm.quant_attn_block_split_plain(x, *k13, ln_eps=1e-6),
         None, (f_att, f_qkv + f_out), 4 * m * w + 4 * w * w + 20 * w,
         qm.quant_attn_block_split, "siglip_int8", SRC_Q),
        ("row_quant[LN, SO400M bf16 rows]", f"{JAX_QM}:565", "codes",
         lambda: qm.row_quant(x2, *ln1, eps=1e-6),
         lambda: qm.row_quant_plain(x2, *ln1, eps=1e-6), None, 0,
         2 * m * w + 8 * w + m * w + 4 * m, qm.row_quant, "siglip_int8",
         SRC_Q),
        ("row_quant[requantize fp32 c_fc rows, 4304]", f"{JAX_QM}:113",
         "codes", lambda: qm.row_quant(y), lambda: qm.row_quant_plain(y),
         None, 0, 4 * m * hid + m * hid + 4 * m, qm.row_quant, "siglip_int8",
         SRC_Q),
        ("int8_gemm[c_fc, gelu_tanh, fp32 out]", f"{JAX_QM}:109", "kernel",
         lambda: qm.int8_gemm(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                              out_dtype=torch.float32),
         lambda: qm.int8_gemm_plain(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                                    out_dtype=torch.float32),
         lambda: int_mm(mm_in[w], wf8), (0, f_fc),
         m * w + 4 * m + w * hid + 8 * hid + 4 * m * hid, qm.int8_gemm,
         "siglip_int8", SRC_Q),
        ("int8_gemm[c_fc, gelu_tanh, quantized out]", f"{JAX_QM}:109",
         "codes",
         lambda: qm.int8_gemm(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                              out_dtype=torch.int8),
         lambda: qm.int8_gemm_plain(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                                    out_dtype=torch.int8),
         lambda: int_mm(mm_in[w], wf8), (0, f_fc),
         m * w + 4 * m + w * hid + 8 * hid + m * hid + 4 * m, qm.int8_gemm,
         "siglip_int8", SRC_Q),
        ("int8_gemm[qkv groups, q-scale]", f"{JAX_QM}:576", "kernel",
         lambda: qm.int8_gemm(x8, sx, qm._qkv_operand(wg), sg.reshape(-1),
                              bg.reshape(-1), q_scale=1.0 / math.sqrt(d),
                              q_width=gd),
         lambda: qm.int8_gemm_plain(x8, sx, qm._qkv_operand(wg),
                                    sg.reshape(-1), bg.reshape(-1),
                                    q_scale=1.0 / math.sqrt(d), q_width=gd),
         lambda: int_mm(mm_in[w], qm._qkv_operand(wg).t()), (0, f_qkv),
         m * w + 4 * m + 3 * w * w + 24 * w + 2 * m * 3 * w, qm.int8_gemm,
         "siglip_int8", SRC_Q),
        ("attention[hd72, grouped, q-scaled, fp32 out]", f"{JAX_QM}:586",
         "attention",
         lambda: bk.attention(qkv, heads, group_heads=heads // groups,
                              q_scaled=True, out_dtype=torch.float32),
         lambda: bk.attention_plain(qkv, heads, group_heads=heads // groups,
                                    q_scaled=True, normalize_p=True,
                                    out_dtype=torch.float32),
         None, f_att, 2 * m * 3 * w + 4 * m * w, bk.attention, "siglip_int8"),
        ("int8_gemm[out-proj, 8 group partials + x]", f"{JAX_QM}:605",
         "kernel",
         lambda: qm.int8_gemm(a8, sa, wout, so, bo, residual=x2,
                              out_dtype=torch.bfloat16, groups=groups),
         lambda: qm.int8_gemm_plain(a8, sa, wout, so, bo, residual=x2,
                                    out_dtype=torch.bfloat16, groups=groups),
         None, (0, f_out), m * w + 4 * m * groups + w * w + 8 * w
         + 2 * m * w + 2 * m * w, qm.int8_gemm, "siglip_int8", SRC_Q),
    ])
    # the quantized output against the two launches it replaced, and the
    # normalised-P attention at head_dim 72 over the grouped layout (the
    # NORM_P instance runs at 64, 88 and 104 on the paths)
    core = {"qout_c_fc": qout_against_two_launches(
        "int8_gemm[SO400M c_fc, gelu_tanh]",
        lambda: qm.int8_gemm(x8, sx, wf8.t(), sf, bf, act="gelu_tanh",
                             out_dtype=torch.int8),
        lambda: qm.row_quant(qm.int8_gemm(x8, sx, wf8.t(), sf, bf,
                                          act="gelu_tanh",
                                          out_dtype=torch.float32)), timed)}
    compare("attention[hd72, 8 groups, q-scaled, fp32 out, P normalised]",
            bk.attention(qkv, heads, group_heads=heads // groups,
                         q_scaled=True, out_dtype=torch.float32,
                         normalize_p=True),
            bk.attention_plain(qkv, heads, group_heads=heads // groups,
                               q_scaled=True, out_dtype=torch.float32,
                               normalize_p=True), "attention")
    # the int8 GEMM core alone (no activation, bf16 out; the out-proj with
    # its 8 group partials and x) at the three SO400M shapes, beside
    # torch._int_mm's int32 product at the same shape
    for label, a_, s_, w_, ws_, b_, kw, n_ in (
            ("qkv", x8, sx, qm._qkv_operand(wg), sg.reshape(-1),
             bg.reshape(-1), {}, 3 * w),
            ("out-proj", a8, sa, wout, so, bo,
             dict(residual=x2, groups=groups), w),
            ("c_fc", x8, sx, wf8.t(), sf, bf, {}, hid)):
        ops = 2 * m * a_.shape[1] * n_
        t_core = timed(lambda: qm.int8_gemm(a_, s_, w_, ws_, b_, **kw))
        t_mm = timed(lambda: int_mm(a_, w_.t()))
        core[label] = dict(ms=t_core, tops=ops / t_core / 1e9,
                           int_mm_ms=t_mm, int_mm_tops=ops / t_mm / 1e9)
        print(f"[kernels] int8 core at SO400M {label} [{m} x {n_}, K "
              f"{a_.shape[1]}]: {t_core:.4f} ms = {ops / t_core / 1e9:.1f} "
              f"TOPS; torch._int_mm {t_mm:.4f} ms = {ops / t_mm / 1e9:.1f} "
              f"TOPS")
    del x, x2, patches, h8, hs, x8, y, qkv, attn, a8, mm_in
    k13_ops = f_qkv + f_out
    print(f"[kernels] SO400M int8 bound per block at batch {b}: K13 "
          f"{1e3 * (k13_ops / PEAK_INT8_OPS + f_att / PEAK_FLOPS):.4f} ms, K9 "
          f"and K10 {1e3 * f_fc / PEAK_INT8_OPS:.4f} ms each; {SL_LAYERS} "
          f"blocks {1e3 * SL_LAYERS * (k13_ops / PEAK_INT8_OPS + f_att / PEAK_FLOPS + 2 * f_fc / PEAK_INT8_OPS):.2f} ms")

    # every option of K8 (later slices call them) and a ragged K13, small
    wf8s, sfs = weight(w, 344)
    xs, rs, b344 = rnd(300, w, scale=2.0), rnd(300, 344), vec(344)
    for act in ("none", "quick_gelu", "gelu_tanh", "gelu_poly"):
        for label, opts in (("", {}), ("+res", dict(residual=rs)),
                            ("+LN", dict(ln_scale=ln2[0], ln_bias=ln2[1])),
                            ("+LN+res", dict(residual=rs, ln_scale=ln2[0],
                                             ln_bias=ln2[1]))):
            compare(f"quant_matmul_fused[{act}{label}, 300x{w}x344]",
                    qm.quant_matmul_fused(xs, wf8s, sfs, b344, act=act,
                                          **opts),
                    qm.quant_matmul_fused_plain(xs, wf8s, sfs, b344,
                                                act=act, **opts), "kernel")
    xr = rnd(4, 592, w)
    compare("quant_attn_block_split[B=4, S=577 in 592, padded_io]",
            qm.quant_attn_block_split(xr, *k13, ln_eps=1e-6, padded_io=True,
                                      seq_len=577)[:, :577],
            qm.quant_attn_block_split_plain(xr, *k13, ln_eps=1e-6,
                                            padded_io=True,
                                            seq_len=577)[:, :577], "block")
    return core


def qout_against_two_launches(label, one, two, timed) -> dict:
    """The int8 GEMM's quantized output (one launch) against the fp32 GEMM
    then row_quant (two launches, the composition it replaced), both
    kernels on the same inputs: codes and scales equal bit for bit; both
    timed."""
    import torch

    (q1, s1), (q2, s2) = one(), two()
    torch.cuda.synchronize()
    same = bool(torch.equal(q1, q2) and torch.equal(s1, s2))
    t1, t2 = timed(one), timed(two)
    print(f"[kernels] {label}: quantized output {t1:.4f} ms, fp32 y + "
          f"row_quant {t2:.4f} ms; codes and scales equal bit for bit: "
          f"{same}")
    check(same, f"{label}: the quantized output differs from fp32 y + "
          "row_quant")
    return dict(one_launch_ms=t1, two_launches_ms=t2)


def vit_int8_kernel_cases(rnd, vec, run_cases, timed) -> dict:
    """3e. The CLIP ViT int8 kernels at ViT-B/16 shapes, batch 64 (S=197,
    W=768, 12 heads of 64, hidden 3072, quick_gelu): K12 and K11 (the
    ``merge_blocks="off"`` halves), K14 with one and two MLP chunks, with
    gelu_poly and at ViT-B/32's S=50, each against its plain version; and
    the pieces K14 runs at these shapes: its four GEMMs (each timed beside
    ``torch._int_mm`` at its shape, the GEMM core only), the attention at
    head_dim 64 with fp32 output, and the requantize of the attention row."""
    import torch

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    m, d = B * S, W // HEADS
    f32 = torch.float32

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5, dtype=f32))
        return qm.int8_weight(w8), ws

    x = rnd(B, S, W)
    x2 = x.reshape(m, W)
    wq, sq = weight(W, 3 * W)
    wo, so = weight(W, W)
    w1, s1 = weight(W, HIDDEN)
    w2, s2 = weight(HIDDEN, W)
    ln1, ln2 = (vec(W, one=True), vec(W)), (vec(W, one=True), vec(W))
    attn = (wq, sq, vec(3 * W), wo, so, vec(W), *ln1)
    mlp = (w1, s1, vec(HIDDEN), w2, s2, vec(W))
    k14 = (*attn, *mlp, *ln2, HEADS)
    # the pieces' inputs, as K14 makes them
    x8, sx = qm.row_quant(x2, *ln1)
    qkv = qm.int8_gemm(x8, sx, wq.t(), sq, attn[2], q_scale=d ** -0.5,
                       q_width=W).reshape(B, S, 3 * W)
    att = bk.attention(qkv, HEADS, q_scaled=True, out_dtype=f32,
                       normalize_p=True)
    a8, sa = qm.row_quant(att.reshape(m, W))
    y1 = qm.int8_gemm(a8, sa, wo.t(), so, attn[5], residual=x2, out_dtype=f32)
    l8, sl = qm.row_quant(y1, *ln2)
    h = qm.int8_gemm(l8, sl, w1.t(), s1, mlp[2], act="quick_gelu",
                     out_dtype=f32)
    h8, hs = qm.row_quant(h)
    x50 = rnd(B, 50, W)
    mm_in = {kk: torch.randint(-127, 128, (m, kk), dtype=torch.int8,
                               device=x.device) for kk in (W, HIDDEN)}
    int_mm = torch._int_mm
    f_qkv, f_out, f_fc = 2 * m * W * 3 * W, 2 * m * W * W, 2 * m * W * HIDDEN
    f_att = 4 * B * HEADS * S * S * d
    w_bytes = 4 * W * W + 2 * W * HIDDEN + 8 * (5 * W + HIDDEN) + 16 * W
    k12_ops, k11_ops = f_qkv + f_out, 2 * f_fc
    print(f"[kernels] CLIP ViT int8 at ViT-B/16 shapes: B={B} S={S} W={W} "
          f"{HEADS}x{d} hidden {HIDDEN}; per block K14 {(k12_ops + k11_ops) / 1e9:.1f}"
          f" GOP int8 + {f_att / 1e9:.1f} GFLOP bf16 attention")

    def full(xx, **kw):
        return (lambda: qm.quant_full_block_fused(xx, *k14, **kw),
                lambda: qm.quant_full_block_fused_plain(xx, *k14, **kw))

    def chunked(n_ch):  # K14's c_fc over n_ch chunks, each its own scale
        kw = dict(act="quick_gelu", out_dtype=torch.int8,
                  out_group=HIDDEN // n_ch,
                  out_group_pad=qm._group_pad(HIDDEN // n_ch))
        return (lambda: qm.int8_gemm(l8, sl, w1.t(), s1, mlp[2], **kw),
                lambda: qm.int8_gemm_plain(l8, sl, w1.t(), s1, mlp[2], **kw))

    run_cases([
        ("quant_attn_block_fused", f"{JAX_QM}:490", "int8_block",
         lambda: qm.quant_attn_block_fused(x, *attn, HEADS),
         lambda: qm.quant_attn_block_fused_plain(x, *attn, HEADS), None,
         (f_att, k12_ops), 4 * m * W + 4 * W * W + 40 * W,
         qm.quant_attn_block_fused, "vit_int8_off", SRC_Q),
        ("quant_mlp_block_fused", f"{JAX_QM}:238", "int8_mlp",
         lambda: qm.quant_mlp_block_fused(x2, *mlp, *ln2),
         lambda: qm.quant_mlp_block_fused_plain(x2, *mlp, *ln2), None,
         (0, k11_ops), 4 * m * W + 2 * W * HIDDEN + 8 * (HIDDEN + 3 * W),
         qm.quant_mlp_block_fused, "vit_int8_off", SRC_Q),
        ("quant_full_block_fused", f"{JAX_QM}:794", "int8_block", *full(x),
         None, (f_att, k12_ops + k11_ops), 4 * m * W + w_bytes,
         qm.quant_full_block_fused, "vit_int8", SRC_Q),
        ("quant_full_block_fused[mlp_chunks=2]", f"{JAX_QM}:794",
         "int8_block", *full(x, mlp_chunks=2), None,
         (f_att, k12_ops + k11_ops), 4 * m * W + w_bytes,
         qm.quant_full_block_fused, "vit_int8", SRC_Q),
        ("quant_full_block_fused[gelu_poly]", f"{JAX_QM}:794", "int8_block",
         *full(x, act="gelu_poly"), None, (f_att, k12_ops + k11_ops),
         4 * m * W + w_bytes, qm.quant_full_block_fused, "vit_int8", SRC_Q),
        ("quant_full_block_fused[ViT-B/32, S=50]", f"{JAX_QM}:794",
         "int8_block", *full(x50), None,
         (4 * B * HEADS * 50 * 50 * d, (k12_ops + k11_ops) * 50 // S),
         4 * B * 50 * W + w_bytes, qm.quant_full_block_fused, "vit_int8",
         SRC_Q),
        ("int8_gemm[ViT-B/16 qkv, q-scale]", f"{JAX_QM}:731", "kernel",
         lambda: qm.int8_gemm(x8, sx, wq.t(), sq, attn[2], q_scale=d ** -0.5,
                              q_width=W),
         lambda: qm.int8_gemm_plain(x8, sx, wq.t(), sq, attn[2],
                                    q_scale=d ** -0.5, q_width=W),
         lambda: int_mm(mm_in[W], wq), (0, f_qkv),
         m * W + 4 * m + 3 * W * W + 24 * W + 2 * m * 3 * W, qm.int8_gemm,
         "vit_int8", SRC_Q),
        ("attention[hd64, one group, q-scaled, fp32 out, P normalised]",
         f"{JAX_QM}:743", "attention",
         lambda: bk.attention(qkv, HEADS, q_scaled=True, out_dtype=f32,
                              normalize_p=True),
         lambda: bk.attention_plain(qkv, HEADS, q_scaled=True,
                                    normalize_p=True, out_dtype=f32),
         None, f_att, 2 * m * 3 * W + 4 * m * W, bk.attention, "vit_int8"),
        ("row_quant[requantize the fp32 attention row, 768]", f"{JAX_QM}:761",
         "codes", lambda: qm.row_quant(att.reshape(m, W)),
         lambda: qm.row_quant_plain(att.reshape(m, W)), None, 0,
         4 * m * W + m * W + 4 * m, qm.row_quant, "vit_int8", SRC_Q),
        ("int8_gemm[ViT-B/16 out-proj, fp32 y1 + x]", f"{JAX_QM}:764",
         "kernel",
         lambda: qm.int8_gemm(a8, sa, wo.t(), so, attn[5], residual=x2,
                              out_dtype=f32),
         lambda: qm.int8_gemm_plain(a8, sa, wo.t(), so, attn[5], residual=x2,
                                    out_dtype=f32),
         lambda: int_mm(mm_in[W], wo), (0, f_out),
         m * W + 4 * m + W * W + 8 * W + 2 * m * W + 4 * m * W, qm.int8_gemm,
         "vit_int8", SRC_Q),
        ("int8_gemm[ViT-B/16 c_fc, quick_gelu, fp32 out]", f"{JAX_QM}:781",
         "kernel",
         lambda: qm.int8_gemm(l8, sl, w1.t(), s1, mlp[2], act="quick_gelu",
                              out_dtype=f32),
         lambda: qm.int8_gemm_plain(l8, sl, w1.t(), s1, mlp[2],
                                    act="quick_gelu", out_dtype=f32),
         lambda: int_mm(mm_in[W], w1), (0, f_fc),
         m * W + 4 * m + W * HIDDEN + 8 * HIDDEN + 4 * m * HIDDEN,
         qm.int8_gemm, "vit_int8", SRC_Q),
        ("int8_gemm[ViT-B/16 c_fc, quick_gelu, quantized out]",
         f"{JAX_QM}:781", "codes",
         lambda: qm.int8_gemm(l8, sl, w1.t(), s1, mlp[2], act="quick_gelu",
                              out_dtype=torch.int8),
         lambda: qm.int8_gemm_plain(l8, sl, w1.t(), s1, mlp[2],
                                    act="quick_gelu", out_dtype=torch.int8),
         lambda: int_mm(mm_in[W], w1), (0, f_fc),
         m * W + 4 * m + W * HIDDEN + 8 * HIDDEN + m * HIDDEN + 4 * m,
         qm.int8_gemm, "vit_int8", SRC_Q),
        ("int8_gemm[ViT-B/16 c_fc, quick_gelu, quantized out, 2 chunks]",
         f"{JAX_QM}:781", "codes", *chunked(2), lambda: int_mm(mm_in[W], w1),
         (0, f_fc), m * W + 4 * m + W * HIDDEN + 8 * HIDDEN + m * HIDDEN
         + 8 * m, qm.int8_gemm, "vit_int8", SRC_Q),
        ("int8_gemm[ViT-B/16 c_proj, residual-first]", f"{JAX_QM}:779",
         "kernel",
         lambda: qm.int8_gemm(h8, hs, w2.t(), s2, mlp[5], residual=y1,
                              out_dtype=torch.bfloat16, residual_first=True),
         lambda: qm.int8_gemm_plain(h8, hs, w2.t(), s2, mlp[5], residual=y1,
                                    out_dtype=torch.bfloat16,
                                    residual_first=True),
         lambda: int_mm(mm_in[HIDDEN], w2), (0, f_fc),
         m * HIDDEN + 4 * m + HIDDEN * W + 8 * W + 4 * m * W + 2 * m * W,
         qm.int8_gemm, "vit_int8", SRC_Q),
    ])
    print(f"[kernels] ViT-B/16 int8 bound per block at batch {B}: K14 "
          f"{1e3 * ((k12_ops + k11_ops) / PEAK_INT8_OPS + f_att / PEAK_FLOPS):.4f}"
          f" ms, K12 {1e3 * (k12_ops / PEAK_INT8_OPS + f_att / PEAK_FLOPS):.4f}"
          f" ms, K11 {1e3 * k11_ops / PEAK_INT8_OPS:.4f} ms")
    figures = {}
    for n_ch in (1, 2):
        one, _ = chunked(n_ch)
        figures[f"qout_vit_c_fc_{n_ch}"] = qout_against_two_launches(
            f"int8_gemm[ViT-B/16 c_fc, quick_gelu, {n_ch} chunk(s)]", one,
            lambda: qm.row_quant(
                qm.int8_gemm(l8, sl, w1.t(), s1, mlp[2], act="quick_gelu",
                             out_dtype=f32), group=HIDDEN // n_ch,
                group_pad=qm._group_pad(HIDDEN // n_ch)),
            timed)
    del x, x2, x8, qkv, att, a8, y1, l8, h, h8, x50, mm_in
    return figures


def vit_int8_path(bk, images, bf16_probs, bf16_rate):
    """5c. ClassifierEngine("random:ViT-B/16", quantize="int8") +
    DynamicBatcher on the same seeded weights and requests as the bf16
    engine; returns the launch counts of the batcher run and of the
    ``merge_blocks="off"`` encode, images/s at batch 64, the path's figures
    and the engine."""
    import torch

    from aihab_clip_tpu_torch.models import quant_vit as qv
    from aihab_clip_tpu_torch.models.fast_vit import _ln
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine = ClassifierEngine(model="random:ViT-B/16", batch_size=64,
                              quantize="int8", device="cuda")
    engine.warmup()
    cfg, qp = engine.bundle.config, engine._qparams
    print(f"[vit int8] random:ViT-B/16 quantize='int8': built + warm in "
          f"{time.perf_counter() - t0:.1f}s")

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        qm.reset_launch_counts()

    reset()
    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    batcher.start()
    t0 = time.perf_counter()
    futures = [batcher.submit(img) for img in images]
    probs = np.stack([f.result(timeout=600) for f in futures])
    wall = time.perf_counter() - t0
    batcher.stop()
    run = counts()
    n = batcher.stats.batches
    print(f"[vit int8] {len(futures)} requests answered in {wall:.3f}s over "
          f"{n} batches; launches {run}")
    check(probs.shape == (len(images), 20), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)), "rows not softmax")
    layers = cfg.vision_layers
    want = {"quant_matmul_fused": n, "quant_full_block_fused": layers * n,
            "quant_attn_block_fused": 0, "quant_mlp_block_fused": 0,
            "attention": layers * n, "row_quant": (1 + 3 * layers) * n,
            "int8_gemm": (1 + 4 * layers) * n, "full_block_fused": 0,
            "ln_gemm": 0, "gemm_residual": 0}
    for key, v in want.items():
        check(run[key] == v, f"{key} launched {run[key]} times for {n} "
              f"batches (want {v})")

    ref_tower = copy.copy(engine.bundle.model.visual)
    ref_tower.dtype = torch.float32
    batch = torch.from_numpy(images[:B]).to(dev)
    figures = {}
    with torch.inference_mode():
        xb = eval_transform(batch, 224, dtype=torch.bfloat16)
        feats = qv.vit_encode_int8(qp, xb, cfg, project=True)[1].float()
        with plain_int8_kernels():
            plain = qv.vit_encode_int8(qp, xb, cfg, project=True)[1].float()
        ref_feats = ref_tower(eval_transform(batch, 224), project=True)[1]
        for name, other in (("plain", plain), ("fp32", ref_feats)):
            cos = torch.nn.functional.cosine_similarity(feats, other, dim=-1)
            figures[f"cos_{name}_min"] = cos.min().item()
            print(f"[vit int8] features vs {'the same encode with every kernel plain' if name == 'plain' else 'the fp32 canonical tower'} "
                  f"({B} images): cosine min {cos.min().item():.6f} mean "
                  f"{cos.mean().item():.6f} (limit {INT8_COS[name]})")
            check(cos.min().item() >= INT8_COS[name], f"int8 ViT cosine vs "
                  f"{name}")
        ref_probs = torch.softmax(100.0 * torch.nn.functional.normalize(
            ref_feats, dim=-1) @ engine._text_weights, -1).cpu().numpy()
        figures["top1_vs_bf16"] = float(
            (bf16_probs.argmax(-1) == probs.argmax(-1)).mean())
        figures["top1_vs_fp32"] = float(
            (ref_probs.argmax(-1) == probs[:B].argmax(-1)).mean())
        print(f"[vit int8] top-1 agreement with the bf16 engine: "
              f"{figures['top1_vs_bf16']:.4f} over {len(images)}, max|dprob| "
              f"{np.abs(bf16_probs - probs).max():.4g}; with the fp32 "
              f"canonical tower {figures['top1_vs_fp32']:.4f} over {B}")

        # the two-kernel halves (K12 + K11) as a path of its own
        reset()
        off = qv.vit_encode_int8(qp, xb, cfg, project=True,
                                 merge_blocks="off")[1].float()
        torch.cuda.synchronize()
        run_off = counts()
        cos_off = torch.nn.functional.cosine_similarity(off, ref_feats, dim=-1)
        cos_k14 = torch.nn.functional.cosine_similarity(off, feats, dim=-1)
        figures["cos_off_fp32_min"] = cos_off.min().item()
        print(f"[vit int8] merge_blocks='off' launches {run_off}; cosine min "
              f"{cos_off.min().item():.6f} vs the fp32 tower (limit "
              f"{INT8_COS['fp32']}), {cos_k14.min().item():.6f} vs K14")
        check(run_off["quant_attn_block_fused"] == layers
              and run_off["quant_mlp_block_fused"] == layers
              and run_off["quant_full_block_fused"] == 0
              and run_off["quant_matmul_fused"] == 1, "K12/K11 counts")
        check(cos_off.min().item() >= INT8_COS["fp32"], "merge_blocks='off' "
              "int8 cosine")

    # where the time goes at batch 64 (CUDA events, stages of one run)
    split, t_all = classify_split(engine, batch, [
        ("k8", lambda x: qv.vit_patchify_int8(qp, x, cfg)),
        ("blocks", lambda t: qv.apply_int8_vit_blocks(
            qp["transformer"], t, cfg, start=0, stop=layers)),
        ("ln_post_proj", lambda t: _ln(
            t[:, 0, :], qp["ln_post"]["scale"], qp["ln_post"]["bias"])
            @ qp["proj"].to(t.dtype))])
    figures.update(classify_ms=t_all, **{f"{k}_ms": v for k, v in
                                         split.items()})
    print(f"[vit int8] batch 64 device time: classify {t_all:.3f} ms; its "
          f"stages in one run {sum(split.values()):.3f} = eval_transform "
          f"{split['eval_transform']:.3f} + K8 patchify (+ cls, positions, "
          f"ln_pre) {split['k8']:.3f} + {layers} blocks "
          f"{split['blocks']:.3f} + ln_post/proj {split['ln_post_proj']:.3f}"
          f" + head {split['head']:.3f}")
    rate = images_per_s(engine, 64, 224)
    print(f"[vit int8] classify_batch end-to-end at batch 64: {rate:.1f} "
          f"images/s (bf16 engine {bf16_rate:.1f}, same run)")
    del batch, xb, ref_tower
    return run, run_off, rate, figures, engine


def synthetic_dataset(rng, n: int, dim: int):
    """n random uint8 [dim, dim, 3] images with random labels of 20 classes
    (the labels drawn first)."""
    from aihab_clip_tpu_torch.data import ImageArrayDataset

    labels = rng.integers(0, 20, n)
    return ImageArrayDataset(
        images=rng.integers(0, 256, (n, dim, dim, 3), dtype=np.uint8),
        labels=labels, l2_labels=np.zeros(n, np.int64),
        poly_labels=np.full(n, -1, np.int64), plot_word_labels=[""] * n,
        poly_word_labels=[""] * n,
        file_names=[f"synthetic_{i}.jpg" for i in range(n)],
        plot_idx=list(range(n)), image_sources=["synthetic"] * n)


def step_grads_fn(model, trainable, tokens, imgs, labs, valid):
    """``step_grads(cfg, prefix) -> (loss, flattened trainable gradient)``
    of one train step's loss on one batch (augmentation of step 0)."""
    import torch

    from aihab_clip_tpu_torch.train.peft import _build_loss_fn, step_generator

    def step_grads(c, pp):
        loss_fn = _build_loss_fn(model, c, None, tokens)
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(imgs, labs, valid, step_generator(SEED, 0, 0), pp)
        loss.backward()
        torch.cuda.synchronize()
        grad = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).float().flatten()
                          for _, p in trainable])
        return loss.item(), grad

    return step_grads


def check_step(tag, name, got, ref, gate):
    """A train step's (loss, gradient) against a reference step's: loss
    relative |d| and gradient cosine within ``gate``; returns the figures."""
    import torch

    (loss_k, g_k), (loss_r, g_r) = got, ref
    rel = abs(loss_k - loss_r) / abs(loss_r)
    cos = torch.nn.functional.cosine_similarity(g_k, g_r, dim=0).item()
    lim_rel, lim_cos = gate
    print(f"[{tag}] train step vs {name}: loss {loss_k:.6f} vs {loss_r:.6f}, "
          f"rel |d| {rel:.3e} (limit {lim_rel:g}); gradient cosine {cos:.6f} "
          f"(limit {lim_cos:g}), |g| {g_k.norm().item():.4g} vs "
          f"{g_r.norm().item():.4g}")
    check(rel <= lim_rel and cos >= lim_cos, f"{tag} train step vs {name}")
    return dict(loss=loss_r, loss_rel=rel, grad_cos=cos)


def timed_steps(step, imgs, labs, valid, pp, epoch, reset=None):
    """CUDA-event ms of 5 train steps after 2 warm-up ones (``reset()``
    just before the first timed one)."""
    import torch

    from aihab_clip_tpu_torch.train.peft import step_generator

    times = []
    for i in range(7):
        if i == 2 and reset is not None:
            reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(imgs, labs, valid, step_generator(SEED, epoch, i), PEFT_LR, pp)
        e1.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return times


def vit_peft_path(model, bk):
    """6c. The default fine-tune on the offline fallback tower, ViT-B/16 at
    224 (``configs/base.yaml`` + ``cs.yaml``: batch 16 from 439x439 uint8,
    random crop + rotation, tune_text, unlocked_groups 11, unlocked_layers
    1, lr_v 5e-5, bf16 over fp32 Adam), with the default ``fused_prefix``:
    one train step against plain kernels and against the fp32 canonical
    tower, 2 K1 per step; the ``prefix_quant`` step (2 K14) against the
    bf16-prefix step; both steps' device times; then ``finetune`` itself
    with ``fused_prefix=-1``.  Trains ``model`` in place; returns the
    figures (the ``finetune`` run's launches are checked here)."""
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import build_text_head, fast_vit
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _pack_prefix, _quantize_prefix, build_lock_mask,
        finetune, make_train_step, peft_fused_prefix_len)

    dev = torch.device("cuda")
    mcfg = model.config
    layers = mcfg.vision_layers

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        qm.reset_launch_counts()

    n_prefix = peft_fused_prefix_len(mcfg, PEFT_UNLOCKED, dev)
    check(n_prefix == VIT_PEFT_PREFIX, f"ViT fused prefix {n_prefix}")
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    tokens = build_text_head(model, prompts, 20, tpc)["prompt_tokens"]
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=PEFT_LR, epochs=1, crop_mode="random", rotation=True,
                     tune_text=True, num_templates=tpc,
                     compute_dtype=torch.bfloat16)
    mask = build_lock_mask(model, layers, mcfg.transformer_layers,
                           unlocked_groups=PEFT_UNLOCKED, tune_text=True,
                           unlocked_text_layers=1)
    trainable = [(n, p) for n, p in model.named_parameters() if mask[n]]
    print(f"[vit peft] {len(trainable)} trainable leaves, "
          f"{sum(p.numel() for _, p in trainable):,} parameters; fused prefix "
          f"{n_prefix} (default fused_prefix), suffix {layers - n_prefix} "
          "blocks")

    n_all = sum(VIT_PEFT_SPLITS)
    ds = synthetic_dataset(np.random.default_rng(SEED + 3), n_all,
                           PEFT_DECODE)
    n_tr, _, n_te = VIT_PEFT_SPLITS
    train_view = SplitView(ds, np.arange(n_tr), PEFT_B, shuffle=True,
                           seed=SEED)
    test_view = SplitView(ds, np.arange(n_tr, n_all), PEFT_B)
    batch = next(train_view.batches(0))
    imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
        batch.images, batch.labels, batch.valid))
    step_grads = step_grads_fn(model, trainable, tokens, imgs, labs, valid)

    cfg_p = dataclasses.replace(cfg, fused_prefix=n_prefix)
    pprefix = _pack_prefix(model, cfg_p)
    check(len(pprefix["blocks"]) == n_prefix, "the K1 prefix pack")
    reset()
    kern = step_grads(cfg_p, pprefix)
    per_step = counts()
    print(f"[vit peft] launches in one step: {per_step}")
    check(per_step["full_block_fused"] == n_prefix
          and per_step["quant_full_block_fused"] == 0, "K1 launches per step")
    with mock.patch.object(fast_vit, "full_block_fused",
                           bk.full_block_fused_plain):
        reset()
        plain = step_grads(cfg_p, pprefix)
        check(not any(counts().values()), f"plain step launched {counts()}")
    vis_dt, txt_dt = model.visual.dtype, model.text.dtype
    model.visual.dtype = model.text.dtype = torch.float32
    try:
        fp32 = step_grads(dataclasses.replace(
            cfg, compute_dtype=torch.float32, fused_prefix=0), None)
    finally:
        model.visual.dtype, model.text.dtype = vis_dt, txt_dt
    gates = {name: check_step("vit peft", name, kern, ref,
                              VIT_STEP_GATES[name])
             for name, ref in (("plain", plain), ("fp32", fp32))}

    cfg8 = dataclasses.replace(cfg_p, prefix_quant=True)
    qprefix = _quantize_prefix(model, cfg8)
    reset()
    int8 = step_grads(cfg8, qprefix)
    per_step_q = counts()
    print(f"[vit peft int8] launches in one prefix_quant step: {per_step_q}")
    check(per_step_q["quant_full_block_fused"] == n_prefix
          and per_step_q["full_block_fused"] == 0, "K14 launches per step")
    gates["int8_prefix"] = check_step("vit peft int8", "the bf16-prefix step",
                                      int8, kern, INT8_STEP_GATE)
    model.zero_grad(set_to_none=True)
    del kern, plain, fp32, int8

    # the steps' device times (CUDA events), after warm-up
    step_ms = {}
    torch.cuda.reset_peak_memory_stats()
    for label, c, pp in (("bf16 prefix", cfg_p, pprefix),
                         ("int8 prefix", cfg8, qprefix)):
        _, step = make_train_step(model, c, None, tokens)
        times = step_ms[label] = timed_steps(step, imgs, labs, valid, pp, 1)
        print(f"[vit peft] {label} train step at batch {PEFT_B}: median "
              f"{statistics.median(times):.3f} ms over {len(times)} steps ("
              f"{', '.join(f'{t:.2f}' for t in times)})")
    peak = torch.cuda.max_memory_allocated()

    # the train path: finetune with the default fused_prefix, then the test
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset()
    t0 = time.perf_counter()
    out = finetune(model, train_view, None, test_view, cfg,
                   prompt_tokens=tokens, unlocked_groups=PEFT_UNLOCKED,
                   unlocked_text_layers=1, seed=SEED, verbose=False,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = counts()
    steps, eval_batches = n_tr // PEFT_B, n_te // PEFT_B
    print(f"[vit peft] finetune (fused_prefix=-1): {steps} steps + "
          f"{eval_batches} test batches in {wall:.2f}s; launches {run_counts}")
    check(run_counts["full_block_fused"] == n_prefix * steps
          + layers * eval_batches, "K1 launches in finetune")
    frozen_changed = [n for n, p in model.named_parameters()
                      if not mask[n] and not torch.equal(before[n], p)]
    moved = [n for n, _ in trainable
             if not torch.equal(before[n], out["params"][n])]
    check(not frozen_changed, f"frozen leaves changed: {frozen_changed[:5]}")
    check(len(moved) > 0, "no trainable leaf moved")
    test = out["test"]
    check(int(test["cm"].sum()) == n_te and np.isfinite(test["loss"]),
          "ViT finetune test")
    print(f"[vit peft] {len(moved)} of {len(trainable)} trainable leaves "
          f"moved; test loss {test['loss']:.4f} top1 {test['top1']:.4f}; peak "
          f"memory {peak / 2 ** 30:.2f} GiB")
    train = dict(step_ms=statistics.median(step_ms["bf16 prefix"]),
                 step_ms_all=step_ms["bf16 prefix"],
                 int8_prefix_step_ms=statistics.median(step_ms["int8 prefix"]),
                 int8_prefix_step_ms_all=step_ms["int8 prefix"],
                 peak_gib=peak / 2 ** 30, step_checks=gates, finetune_s=wall,
                 test_loss=test["loss"])
    del before
    return train


def siglip_path(bk):
    """ClassifierEngine + DynamicBatcher on random SO400M weights; returns
    the launch counts of the batcher run, images/s at batch 64 and the
    engine."""
    import torch

    from aihab_clip_tpu_torch.models.fast_siglip import (
        _apply_fused_siglip_blocks, _map_pool, _siglip_embed)
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

    # where the time goes at batch 64 (CUDA events, stages of one run)
    model, packed = engine.bundle.model, engine._packed
    split, t_all = classify_split(engine, batch, [
        ("patchify", lambda x: _siglip_embed(packed, x, cfg)),
        ("blocks", lambda t: _apply_fused_siglip_blocks(
            packed, t, cfg, start=0, stop=cfg.vision_layers)),
        ("map_head", lambda t: _map_pool(model, t))], iters=3)
    print(f"[siglip] batch 64 device time: classify {t_all:.3f} ms; its "
          f"stages in one run {sum(split.values()):.3f} = eval_transform "
          f"{split['eval_transform']:.3f} + patchify {split['patchify']:.3f}"
          f" + {cfg.vision_layers} blocks {split['blocks']:.3f} + MAP head "
          f"{split['map_head']:.3f} + head {split['head']:.3f}")
    rate = images_per_s(engine, 64, dim, n=5)
    print(f"[siglip] classify_batch end-to-end at batch 64: {rate:.1f} "
          f"images/s")
    return counts, rate, engine


@contextlib.contextmanager
def plain_int8_kernels():
    """Every kernel of the int8 SigLIP, ViT and ConvNeXt encodes swapped for
    its plain version."""
    from unittest import mock

    from aihab_clip_tpu_torch.models import fast_convnext as fc
    from aihab_clip_tpu_torch.models import quant_siglip as qs
    from aihab_clip_tpu_torch.models import quant_vit as qv
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    plain = {name: getattr(qm, name + "_plain") for name in (
        "quant_matmul_fused", "quant_attn_block_split",
        "quant_matmul_fused_qout", "quant_matmul_q8in",
        "quant_full_block_fused", "quant_attn_block_fused",
        "quant_mlp_block_fused", "quant_convnext_mlp_block")}
    with contextlib.ExitStack() as stack:
        for module in (qs, qv, fc):
            stack.enter_context(mock.patch.multiple(module, **{
                k: v for k, v in plain.items() if hasattr(module, k)}))
        yield


def siglip_int8_path(bk, bf16_engine, bf16_rate):
    """ClassifierEngine(quantize="int8") + DynamicBatcher on the same seeded
    SO400M weights as the bf16 engine (a second draw: the engine takes a
    model name, as JAX's does); returns the launch counts of the batcher
    run, images/s at batch 64 and the path's figures."""
    import torch

    from aihab_clip_tpu_torch.models import quant_siglip as qs
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    engine = ClassifierEngine(model=SL_MODEL, batch_size=64, quantize="int8",
                              device="cuda")
    t_built = time.perf_counter() - t0
    engine.warmup()
    cfg = engine.bundle.config
    res, dim = cfg.image_resolution, engine.decode_dim
    qp = engine._qparams
    n_groups = int(qp["transformer"]["resblocks_0"]["attn/qkv_g"]["w8_g"]
                   .shape[0])
    print(f"[int8] {SL_MODEL} quantize='int8': built in {t_built:.1f}s (a "
          f"second draw of the seeded weights), warm in "
          f"{time.perf_counter() - t0:.1f}s; {n_groups} head groups")
    check(n_groups == SL_GROUPS, f"int8 head groups {n_groups}")
    images = np.random.default_rng(SEED + 1).integers(
        0, 256, (SL_REQUESTS, dim, dim, 3), dtype=np.uint8)

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    bk.reset_launch_counts()
    qm.reset_launch_counts()
    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    batcher.start()
    t0 = time.perf_counter()
    futures = [batcher.submit(img) for img in images]
    probs = np.stack([f.result(timeout=600) for f in futures])
    wall = time.perf_counter() - t0
    batcher.stop()
    run = counts()
    n = batcher.stats.batches
    print(f"[int8] {len(futures)} requests answered in {wall:.3f}s over {n} "
          f"batches; launches {run}")
    check(probs.shape == (SL_REQUESTS, 20), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)), "rows not softmax")
    want = {"quant_matmul_fused": n, "quant_attn_block_split": SL_LAYERS * n,
            "quant_matmul_fused_qout": SL_LAYERS * n,
            "quant_matmul_q8in": SL_LAYERS * n, "attention": SL_LAYERS * n,
            "row_quant": (1 + 3 * SL_LAYERS) * n,
            "int8_gemm": (1 + 4 * SL_LAYERS) * n, "attn_block_split": 0,
            "mlp_block_split": 0, "ln_gemm": 0, "gemm_residual": 0}
    for key, v in want.items():
        check(run[key] == v, f"{key} launched {run[key]} times for {n} "
              f"batches (want {v})")

    # features: against the same encode with every kernel plain, and against
    # the fp32 canonical tower (same parameters, compute dtype fp32)
    ref_tower = copy.copy(engine.bundle.model.visual)
    ref_tower.dtype = torch.float32
    mean, std = normalize_stats_for(cfg)
    n_ref = 16
    batch = torch.from_numpy(images[:64]).to(dev)
    figures = {}
    with torch.inference_mode():
        xb = eval_transform(batch, res, dtype=torch.bfloat16, mean=mean,
                            std=std)
        feats = qs.siglip_encode_int8(qp, engine.bundle.model, xb[:n_ref],
                                      cfg).float()
        with plain_int8_kernels():
            plain = qs.siglip_encode_int8(qp, engine.bundle.model,
                                          xb[:n_ref], cfg).float()
        ref_feats = ref_tower(eval_transform(batch[:n_ref], res, mean=mean,
                                             std=std))
        for name, other in (("plain", plain), ("fp32", ref_feats)):
            cos = torch.nn.functional.cosine_similarity(feats, other, dim=-1)
            figures[f"cos_{name}_min"] = cos.min().item()
            print(f"[int8] features vs {'the same encode with every kernel plain' if name == 'plain' else 'the fp32 canonical tower'} "
                  f"({n_ref} images): cosine min {cos.min().item():.6f} mean "
                  f"{cos.mean().item():.6f} (limit {INT8_COS[name]})")
            check(cos.min().item() >= INT8_COS[name], f"int8 cosine vs {name}")
        ref_probs = torch.softmax(100.0 * torch.nn.functional.normalize(
            ref_feats, dim=-1) @ engine._text_weights, -1).cpu().numpy()
        bf16_probs = np.concatenate([bf16_engine.classify_batch(
            images[i:i + 64]) for i in range(0, SL_REQUESTS, 64)])
        figures["top1_vs_bf16"] = float(
            (bf16_probs.argmax(-1) == probs.argmax(-1)).mean())
        figures["top1_vs_fp32"] = float(
            (ref_probs.argmax(-1) == probs[:n_ref].argmax(-1)).mean())
        print(f"[int8] top-1 agreement with the bf16 engine: "
              f"{figures['top1_vs_bf16']:.4f} over {SL_REQUESTS}, max|dprob| "
              f"{np.abs(bf16_probs - probs).max():.4g}; with the fp32 "
              f"canonical tower {figures['top1_vs_fp32']:.4f} over {n_ref}")

    # where the time goes at batch 64 (CUDA events, stages of one run)
    model = engine.bundle.model
    split, t_all = classify_split(engine, batch, [
        ("k8", lambda x: qs.siglip_patchify_int8(qp, x, cfg)),
        ("blocks", lambda t: qs.apply_int8_siglip_blocks(
            qp["transformer"], t, cfg, start=0, stop=cfg.vision_layers)),
        ("map_head", lambda t: qs._map_pool(model, t))], iters=3)
    figures.update(classify_ms=t_all, **{f"{k}_ms": v for k, v in
                                         split.items()})
    print(f"[int8] batch 64 device time: classify {t_all:.3f} ms; its stages "
          f"in one run {sum(split.values()):.3f} = eval_transform "
          f"{split['eval_transform']:.3f} + K8 patchify {split['k8']:.3f} + "
          f"{cfg.vision_layers} blocks {split['blocks']:.3f} + MAP head "
          f"{split['map_head']:.3f} + head {split['head']:.3f}")
    rate = images_per_s(engine, 64, dim, n=5)
    print(f"[int8] classify_batch end-to-end at batch 64: {rate:.1f} "
          f"images/s (bf16 engine {bf16_rate:.1f}, same run)")
    del engine, model, batch, xb, ref_tower
    torch.cuda.empty_cache()
    return run, rate, figures


def fused_attention_cases(rnd, run_cases, compare, timed) -> None:
    """K6 at the SigLIP PEFT shapes (B=16, S=576, 16 heads of 72, bf16):
    the forward (with the row log-sum-exp) and the backward (dq, dk, dv)
    against their plain versions on the same inputs and output cotangent,
    timed beside SDPA forward and forward + backward (the backward's row
    concatenates its three gradients; the kernels alone and the dq kernel's
    share are printed beside it); then a ragged S at head_dim 72 and
    head_dim 64, compared only."""
    import torch

    from aihab_clip_tpu_torch.ops import attention as att

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def inputs(b, s, heads, d):
        return [rnd(b, s, heads * d) for _ in range(4)]

    def cat_bwd(q, k, v, out, lse, g, heads):
        return torch.cat(att.fused_attention_bwd(q, k, v, out, lse, g, heads),
                         -1)

    for b, s, heads, d in ((4, 577, SL_HEADS, 72), (4, 576, SL_HEADS, 64)):
        q, k, v, g = inputs(b, s, heads, d)
        out, lse = att.fused_attention_fwd(q, k, v, heads)
        compare(f"fused_attention_fwd[B={b} S={s} hd{d}]", out,
                att.fused_attention_plain(q, k, v, heads), "attention")
        for name, got, ref in zip(
                ("dq", "dk", "dv"),
                att.fused_attention_bwd(q, k, v, out, lse, g, heads),
                att.fused_attention_bwd_plain(q, k, v, g, heads)):
            compare(f"fused_attention_bwd {name}[B={b} S={s} hd{d}]", got,
                    ref, "attention_bwd")

    b, s, heads, d = PEFT_B, SL_S, SL_HEADS, SL_W // SL_HEADS
    q, k, v, g = inputs(b, s, heads, d)
    out, lse = att.fused_attention_fwd(q, k, v, heads)
    for name, got, ref in zip(
            ("dq", "dk", "dv"),
            att.fused_attention_bwd(q, k, v, out, lse, g, heads),
            att.fused_attention_bwd_plain(q, k, v, g, heads)):
        compare(f"fused_attention_bwd {name}[B={b} S={s} hd{d}]", got, ref,
                "attention_bwd")
    q4, k4, v4, g4 = (t.reshape(b, s, heads, d).transpose(1, 2).contiguous()
                      for t in (q, k, v, g))
    q4g, k4g, v4g = (t.clone().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(q4g, k4g, v4g), (q4g, k4g, v4g), g4)

    act_bytes = 2 * b * s * SL_W
    print(f"[kernels] fused attention (K6) at B={b} S={s} {heads}x{d}: "
          f"bound fwd {4 * b * heads * s * s * d / 1e9:.1f} GFLOP, bwd "
          f"{10 * b * heads * s * s * d / 1e9:.1f} GFLOP")
    run_cases([
        ("fused_attention_fwd", f"{JAX_ATT}:91", "attention",
         lambda: att.fused_attention_fwd(q, k, v, heads)[0],
         lambda: att.fused_attention_plain(q, k, v, heads),
         lambda: sdpa(q4, k4, v4),
         4 * b * heads * s * s * d, 4 * act_bytes + 4 * b * heads * s,
         att.fused_attention_fwd, "siglip_peft"),
        ("fused_attention_bwd", f"{JAX_ATT}:204", "attention_bwd",
         lambda: cat_bwd(q, k, v, out, lse, g, heads),
         lambda: torch.cat(att.fused_attention_bwd_plain(q, k, v, g, heads),
                           -1),
         sdpa_fwd_bwd, 10 * b * heads * s * s * d, 7 * act_bytes,
         att.fused_attention_bwd, "siglip_peft", SRC_BWD),
    ])
    t_bwd = timed(lambda: att.fused_attention_bwd(q, k, v, out, lse, g, heads))
    t_dq = timed(lambda: att.fused_attention_bwd(q, k, v, out, lse, g, heads,
                                                 need_dkdv=False))
    print(f"[kernels] fused_attention_bwd kernels alone (no torch.cat): "
          f"{t_bwd:.4f} ms = dq kernel with the row term {t_dq:.4f} + dk/dv "
          f"kernel {t_bwd - t_dq:.4f}; SDPA forward + backward "
          f"{timed(sdpa_fwd_bwd):.4f} ms")


@contextlib.contextmanager
def plain_kernels():
    """Every kernel of the SigLIP train step swapped for its plain version
    (K5, K4, and K6 forward and backward as one autograd Function over the
    plain forward and the plain backward)."""
    import torch
    from unittest import mock

    from aihab_clip_tpu_torch.models import fast_siglip
    from aihab_clip_tpu_torch.ops import attention as att
    from aihab_clip_tpu_torch.ops import block_kernel as bk

    class PlainFusedAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, heads):
            ctx.save_for_backward(q, k, v)
            ctx.heads = heads
            return att.fused_attention_plain(q, k, v, heads)

        @staticmethod
        def backward(ctx, g):
            return (*att.fused_attention_bwd_plain(*ctx.saved_tensors, g,
                                                   ctx.heads), None)

    with mock.patch.object(att, "fused_attention", PlainFusedAttention.apply), \
            mock.patch.object(fast_siglip, "attn_block_split",
                              bk.attn_block_split_plain), \
            mock.patch.object(fast_siglip, "mlp_block_split",
                              bk.mlp_block_split_plain):
        yield


def peft_path(engine, bk):
    """The default SigLIP PEFT run on the serving engine's seeded SO400M
    weights (no second draw of 1.13 B parameters).  Returns the launch
    counts of the ``finetune`` run and the train figures."""
    import torch

    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import build_text_head, fast_siglip
    from aihab_clip_tpu_torch.models.text_head import compute_text_weights
    from aihab_clip_tpu_torch.ops import attention as att
    from aihab_clip_tpu_torch.ops.fast_warp import fast_train_transform
    from aihab_clip_tpu_torch.ops.preprocess import normalize_stats_for
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train import evaluate, masked_ce_metrics
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _pack_prefix, _quantize_prefix, build_lock_mask,
        finetune, make_train_step, peft_fused_prefix_len, step_generator)

    dev = torch.device("cuda")
    model, mcfg = engine.bundle.model, engine.bundle.config
    layers = mcfg.vision_layers
    n_suffix = layers - PEFT_PREFIX

    def counts():
        return {**bk.launch_counts(), **att.launch_counts(),
                **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        att.reset_launch_counts()
        qm.reset_launch_counts()

    n_prefix = peft_fused_prefix_len(mcfg, PEFT_UNLOCKED, dev)
    check(n_prefix == PEFT_PREFIX, f"fused prefix {n_prefix}")
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    tokens = build_text_head(model, prompts, 20, tpc,
                             context_length=mcfg.context_length)["prompt_tokens"]
    check(tuple(tokens.shape) == (20 * tpc, mcfg.context_length),
          f"prompt tokens {tuple(tokens.shape)}")
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=PEFT_LR, epochs=1, crop_mode="random", flip=False,
                     rotation=True, tune_text=True, num_templates=tpc,
                     compute_dtype=torch.bfloat16, fused_prefix=n_prefix)
    mask = build_lock_mask(model, layers, mcfg.text_layers,
                           unlocked_groups=PEFT_UNLOCKED, tune_text=True,
                           unlocked_text_layers=1)
    trainable = [(n, p) for n, p in model.named_parameters() if mask[n]]
    n_train = sum(p.numel() for _, p in trainable)
    text_train = sorted(n for n, _ in trainable if n.startswith("text."))
    print(f"[peft] {len(trainable)} trainable leaves, {n_train:,} parameters "
          f"(of {sum(p.numel() for p in model.parameters()):,}); text: "
          f"{text_train}; fused prefix {n_prefix}, suffix {n_suffix} blocks")
    check(text_train == ["text.ln_final.bias", "text.ln_final.weight"],
          "only text/ln_final trains at unlocked_layers=1 (the head quirk)")

    n_all = sum(PEFT_SPLITS)
    ds = synthetic_dataset(np.random.default_rng(SEED + 2), n_all,
                           PEFT_DECODE)
    n_tr, n_val, n_te = PEFT_SPLITS
    train_view = SplitView(ds, np.arange(n_tr), PEFT_B, shuffle=True,
                           seed=SEED)
    val_view = SplitView(ds, np.arange(n_tr, n_tr + n_val), PEFT_B)
    test_view = SplitView(ds, np.arange(n_tr + n_val, n_all), PEFT_B)

    # -- one train step: kernels, plain versions, fp32 canonical tower
    batch = next(train_view.batches(0))
    imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
        batch.images, batch.labels, batch.valid))
    pprefix = _pack_prefix(model, cfg)
    step_grads = step_grads_fn(model, trainable, tokens, imgs, labs, valid)

    reset()
    kern = step_grads(cfg, pprefix)
    per_step = counts()
    print(f"[peft] launches in one step: {per_step}")
    want = {"attn_block_split": PEFT_PREFIX, "mlp_block_split": PEFT_PREFIX,
            "fused_attention_fwd": n_suffix, "fused_attention_bwd": n_suffix,
            "full_block_fused": 0}
    for key, n in want.items():
        check(per_step[key] == n, f"{key}: {per_step[key]} launches in one "
              f"step, want {n}")
    with plain_kernels():
        reset()
        plain = step_grads(cfg, pprefix)
        check(not any(counts().values()), f"plain step launched {counts()}")
    vis_dt, txt_dt = model.visual.dtype, model.text.dtype
    model.visual.dtype = model.text.dtype = torch.float32
    try:
        fp32 = step_grads(dataclasses.replace(
            cfg, compute_dtype=torch.float32, fused_prefix=0), None)
    finally:
        model.visual.dtype, model.text.dtype = vis_dt, txt_dt
    model.zero_grad(set_to_none=True)
    gates = {name: check_step("peft", name, kern, ref, STEP_GATES[name])
             for name, ref in (("plain", plain), ("fp32", fp32))}

    # -- 6b. the same step with the int8 frozen prefix (prefix_quant)
    cfg8 = dataclasses.replace(cfg, prefix_quant=True)
    qprefix = _quantize_prefix(model, cfg8)
    reset()
    int8 = step_grads(cfg8, qprefix)
    per_step_q = counts()
    print(f"[peft int8] launches in one prefix_quant step: {per_step_q}")
    want_q = {"quant_attn_block_split": PEFT_PREFIX,
              "quant_matmul_fused_qout": PEFT_PREFIX,
              "quant_matmul_q8in": PEFT_PREFIX, "quant_matmul_fused": 0,
              "attn_block_split": 0, "mlp_block_split": 0,
              "fused_attention_fwd": n_suffix,
              "fused_attention_bwd": n_suffix}
    for key, n in want_q.items():
        check(per_step_q[key] == n, f"{key}: {per_step_q[key]} launches in "
              f"one prefix_quant step, want {n}")
    gates["int8_prefix"] = check_step("peft int8", "the bf16-prefix step",
                                      int8, kern, INT8_STEP_GATE)
    del kern, plain, fp32, int8

    # -- the step's device time (CUDA events), after warm-up
    opt, step = make_train_step(model, cfg, None, tokens)
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_steps(step, imgs, labs, valid, pprefix, 1, reset=reset)
    peak = torch.cuda.max_memory_allocated()
    for key, n in want.items():
        check(counts()[key] == n * len(step_ms), f"{key} over the timed steps")
    ms = statistics.median(step_ms)

    # the prefix_quant step's device time, the same way
    _, step8 = make_train_step(model, cfg8, None, tokens)
    q_ms = timed_steps(step8, imgs, labs, valid, qprefix, 3)
    print(f"[peft int8] prefix_quant train step at batch {PEFT_B}: median "
          f"{statistics.median(q_ms):.3f} ms over {len(q_ms)} steps ("
          f"{', '.join(f'{t:.2f}' for t in q_ms)}); bf16 prefix {ms:.3f} ms")
    del qprefix, step8

    # where the time goes: the same step rebuilt from the loss's pieces with
    # a CUDA event at each phase boundary; the backward is split into the
    # suffix's and the text tower's by first taking the loss's gradients
    # with respect to the image features f and the text weights w
    mean, std = normalize_stats_for(mcfg)
    res = mcfg.image_resolution
    phases = ("augment", "prefix (K5/K4)", "suffix fwd", "text fwd",
              "loss + dL/df, dL/dw", "suffix bwd", "text bwd", "Adam")

    def split_step(i):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        x = fast_train_transform(imgs, step_generator(SEED, 2, i), res,
                                 crop_mode="random", rotation=True,
                                 dtype=torch.bfloat16, mean=mean, std=std)
        ev[1].record()
        with torch.no_grad():
            x = fast_siglip._apply_fused_siglip_blocks(
                pprefix, fast_siglip._siglip_embed(pprefix, x, mcfg), mcfg,
                start=0, stop=PEFT_PREFIX)
        ev[2].record()
        for blk in model.visual.transformer.resblocks[PEFT_PREFIX:]:
            x = blk(x)
        f = fast_siglip._map_pool(model, x).float()
        f = f / f.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        ev[3].record()
        w = compute_text_weights(model, tokens, 20, tpc)
        ev[4].record()
        loss = masked_ce_metrics(100.0 * f @ w, labs, valid)[0]
        g_f, g_w = torch.autograd.grad(loss, (f, w))
        ev[5].record()
        f.backward(g_f)
        ev[6].record()
        w.backward(g_w)
        ev[7].record()
        opt.step()
        ev[8].record()
        torch.cuda.synchronize()
        return [ev[j].elapsed_time(ev[j + 1]) for j in range(8)]

    splits = [split_step(i) for i in range(7)][2:]
    split = {name: statistics.median(row[j] for row in splits)
             for j, name in enumerate(phases)}
    split_total = statistics.median(sum(row) for row in splits)
    model.zero_grad(set_to_none=True)
    train = dict(step_ms=ms, step_ms_all=step_ms,
                 int8_prefix_step_ms=statistics.median(q_ms),
                 int8_prefix_step_ms_all=q_ms,
                 images_per_s=1e3 * PEFT_B / ms, peak_gib=peak / 2 ** 30,
                 trainable_params=n_train, split_ms=split,
                 split_total_ms=split_total, step_checks=gates)
    print(f"[peft] train step at batch {PEFT_B}: median {ms:.3f} ms over "
          f"{len(step_ms)} steps ({', '.join(f'{t:.2f}' for t in step_ms)}), "
          f"{1e3 * PEFT_B / ms:.1f} trained images/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"[peft] split of one step (CUDA events at the phase boundaries, "
          f"median of 5; {split_total:.3f} ms in all): " + ", ".join(
              f"{name} {t:.3f}" for name, t in split.items()))

    # -- the train path: finetune, then val/test through siglip_encode_fast
    class Log:
        records: list = []

        def log(self, row):
            self.records.append(row)

    log = Log()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset()
    t0 = time.perf_counter()
    out = finetune(model, train_view, val_view, test_view,
                   dataclasses.replace(cfg, fused_prefix=-1),
                   prompt_tokens=tokens, unlocked_groups=PEFT_UNLOCKED,
                   unlocked_text_layers=1, seed=SEED, logger=log,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = counts()
    steps = n_tr // PEFT_B
    eval_batches = (n_val + n_te) // PEFT_B
    print(f"[peft] finetune: {steps} steps + {eval_batches} eval batches in "
          f"{wall:.2f}s; launches {run_counts}")
    for key, n in want.items():
        extra = layers * eval_batches if key in ("attn_block_split",
                                                 "mlp_block_split") else 0
        check(run_counts[key] == n * steps + extra,
              f"{key}: {run_counts[key]} launches in finetune, want "
              f"{n * steps + extra}")
    losses = [r["train_loss"] for r in log.records if "train_loss" in r]
    check(len(losses) == 1 and np.isfinite(losses[0]), f"train loss {losses}")
    with_grad = [n for n, p in model.named_parameters() if mask[n]
                 and p.grad is not None and p.grad.abs().max().item() > 0]
    moved = [n for n in with_grad
             if not torch.equal(before[n], out["params"][n])]
    frozen_changed = [n for n, p in model.named_parameters()
                      if not mask[n] and not torch.equal(before[n], p)]
    print(f"[peft] train loss {losses[0]:.4f}; {len(moved)} of "
          f"{len(with_grad)} trainable leaves with a nonzero gradient moved "
          f"({len(trainable)} trainable); {len(mask) - len(trainable)} frozen "
          f"leaves, {len(frozen_changed)} changed")
    check(len(with_grad) > 0 and len(moved) == len(with_grad),
          "trainable leaves with a gradient did not all move")
    check(not frozen_changed, f"frozen leaves changed: {frozen_changed[:5]}")
    test = out["test"]
    check(int(test["cm"].sum()) == n_te and np.isfinite(test["loss"]),
          f"test confusion matrix sums to {int(test['cm'].sum())}")
    with torch.inference_mode():
        w_now = compute_text_weights(model, tokens, 20, tpc)
    val = evaluate(model, val_view, w_now, res, 20,
                   compute_dtype=torch.bfloat16, return_confusion_matrix=True)
    check(int(val["cm"].sum()) == n_val, "val confusion matrix")
    check(abs(val["loss"] - out["val"]["loss"]) <= 1e-5 * abs(val["loss"]),
          "val loss of finetune and of evaluate differ")
    print(f"[peft] val loss {val['loss']:.4f} top1 {val['top1']:.4f} "
          f"(cm sum {int(val['cm'].sum())}); test loss {test['loss']:.4f} top1 "
          f"{test['top1']:.4f} (cm sum {int(test['cm'].sum())})")
    train.update(finetune_s=wall, train_loss=losses[0],
                 val_loss=val["loss"], test_loss=test["loss"],
                 moved_leaves=len(moved), frozen_leaves=len(mask) - len(trainable))
    del before
    return run_counts, train


def convnext_kernel_cases(rnd, vec, run_cases, compare, timed) -> None:
    """3f. K7 and K15 at the four ConvNeXt base_w stage shapes, batch 64
    (M = 64 * (64 / 2^s)^2 rows of C = 128 * 2^s), each against its plain
    version on the branch out - residual (the residual dominates the
    output); K7 also with ``n_chunks=2`` at stage 3 and once per gelu_poly
    form at stage 0; beside each stage the depthwise 7x7 conv and
    ``torch._int_mm`` at K15's two GEMM shapes."""
    import os

    import torch

    from aihab_clip_tpu_torch.models.convnext import conv_nhwc
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    f32, bf16 = torch.float32, torch.bfloat16
    int_mm = torch._int_mm
    print(f"[kernels] ConvNeXt base_w stage shapes at batch {B}: every K7 and "
          f"K15 launch is 16 M C^2 = {16 * B * 64 * 64 * 128 ** 2 / 1e9:.1f} "
          "G(FL)OP")
    for s, c in enumerate(CX_WIDTHS):
        sp = CX_RES // 4 // 2 ** s
        m = B * sp * sp
        y, res = rnd(m, c), rnd(m, c)
        ln = (vec(c, one=True), vec(c))
        w1 = rnd(c, 4 * c, scale=c ** -0.5, dtype=f32)
        w2 = rnd(4 * c, c, scale=(4 * c) ** -0.5, dtype=f32)
        b1, b2, gamma = vec(4 * c), vec(c), vec(c, scale=0.3)
        k7 = (y, res, *ln, w1.to(bf16), b1, w2.to(bf16), b2, gamma)
        (w1_8, s1), (w2_8, s2) = quantize_weight(w1), quantize_weight(w2)
        w1_8, w2_8 = qm.int8_weight(w1_8), qm.int8_weight(w2_8)
        k15 = (y, res, *ln, w1_8, s1, b1, w2_8, s2, b2, gamma)
        ops = 16 * m * c * c
        vec_bytes = 4 * 9 * c          # LN, b1, b2, gamma; fp32
        act_bytes = 3 * 2 * m * c      # y and res read, out written; bf16
        shape = f"stage {s}: M={m} C={c}"
        cases = [
            (f"convnext_mlp_block[{shape}]", f"{JAX_BK}:688", ("block", res),
             lambda: bk.convnext_mlp_block(*k7),
             lambda: bk.convnext_mlp_block_plain(*k7), None, ops,
             act_bytes + 2 * 8 * c * c + vec_bytes, bk.convnext_mlp_block,
             "convnext"),
            (f"quant_convnext_mlp_block[{shape}]", f"{JAX_QM}:319",
             ("int8_mlp", res), lambda: qm.quant_convnext_mlp_block(*k15),
             lambda: qm.quant_convnext_mlp_block_plain(*k15), None, (0, ops),
             act_bytes + 8 * c * c + 4 * 5 * c + vec_bytes,
             qm.quant_convnext_mlp_block, "convnext_int8", SRC_Q)]
        if s == len(CX_WIDTHS) - 1:
            cases.append(
                (f"convnext_mlp_block[{shape}, n_chunks=2]", f"{JAX_BK}:752",
                 ("block", res), lambda: bk.convnext_mlp_block(*k7, n_chunks=2),
                 lambda: bk.convnext_mlp_block_plain(*k7, n_chunks=2), None,
                 ops, act_bytes + 2 * 8 * c * c + vec_bytes,
                 bk.convnext_mlp_block, "convnext"))
        k7_row, k15_row, *_ = run_cases(cases)
        x4 = y.reshape(B, sp, sp, c)
        dw = rnd(c, 1, 7, 7, scale=1 / 7).contiguous(
            memory_format=torch.channels_last)
        dwb = rnd(c, scale=0.1)
        dw_ms = timed(lambda: conv_nhwc(x4, dw, dwb, padding=3, groups=c))
        a8 = torch.randint(-127, 128, (m, c), dtype=torch.int8,
                           device=y.device)
        h8 = torch.randint(-127, 128, (m, 4 * c), dtype=torch.int8,
                           device=y.device)
        mm = [timed(lambda: int_mm(a8, w1_8)), timed(lambda: int_mm(h8, w2_8))]
        print(f"[kernels] {shape}: depthwise 7x7 (grouped conv on the "
              f"channels-last view) {dw_ms:.4f} ms beside K7 "
              f"{k7_row['ms']:.4f} ms and K15 {k15_row['ms']:.4f} ms; "
              f"torch._int_mm at K15's GEMMs fc1 {mm[0]:.4f} + fc2 "
              f"{mm[1]:.4f} ms")
        k15_row["int_mm_ms"] = mm
        k7_row["dwconv_ms"] = k15_row["dwconv_ms"] = dw_ms
        if s == 0:
            old = os.environ.get("AIHAB_ERF_IMPL")
            try:
                for form in bk.GELU_FORMS:
                    os.environ["AIHAB_ERF_IMPL"] = form
                    compare(f"convnext_mlp_block[{shape}, gelu_poly {form}] "
                            "branch", bk.convnext_mlp_block(*k7).float() - res,
                            bk.convnext_mlp_block_plain(*k7).float() - res,
                            "block")
                    print(f"[kernels] convnext_mlp_block[{shape}, gelu_poly "
                          f"{form}]: {timed(lambda: bk.convnext_mlp_block(*k7)):.4f}"
                          " ms")
            finally:
                if old is None:
                    os.environ.pop("AIHAB_ERF_IMPL", None)
                else:
                    os.environ["AIHAB_ERF_IMPL"] = old
        del y, res, x4, a8, h8, k7, k15
        torch.cuda.empty_cache()
    print(f"[kernels] ConvNeXt base_w bound per batch of {B}: 36 K7 "
          f"{36 * 1e3 * 16 * B * 64 * 64 * 128 ** 2 / PEAK_FLOPS:.3f} ms by "
          "operations")


def convnext_stages(packed, config, qmlp=None):
    """``classify_split`` stages of the ConvNeXt encode: the stem, then per
    stage its downsample, each block's depthwise conv and its K7 (or K15
    with ``qmlp``), each stage's parts summed under one name; the pooled
    head_norm and projection."""
    from aihab_clip_tpu_torch.models import fast_convnext as fc
    from aihab_clip_tpu_torch.models.convnext import conv_nhwc, stage_blocks
    from aihab_clip_tpu_torch.ops.block_kernel import convnext_mlp_block
    from aihab_clip_tpu_torch.ops.quant_matmul import quant_convnext_mlp_block

    def down(x, s):
        dn = packed["down"][s]
        return conv_nhwc(fc._ln_f32(x, *dn["ln"]), *dn["conv"], stride=2)

    def dwconv(x, k):
        return x, conv_nhwc(x, *packed["blocks"][k]["dw"], padding=3,
                            groups=x.shape[-1])

    def mlp(xy, s, b, k):
        x, y = xy
        n, h, w, c = x.shape
        blk = packed["blocks"][k]
        rows = (y.reshape(-1, c), x.reshape(-1, c), *blk["ln"])
        if qmlp is None:
            out = convnext_mlp_block(*rows, blk["w1"], blk["b1"], blk["w2"],
                                     blk["b2"], blk["gamma"])
        else:
            q = qmlp[f"stage{s}_block{b}"]
            out = quant_convnext_mlp_block(
                *rows, q["fc1"]["w8"], q["fc1"]["scale"], blk["b1"],
                q["fc2"]["w8"], q["fc2"]["scale"], blk["b2"], blk["gamma"])
        return out.reshape(n, h, w, c)

    kernel = "K7" if qmlp is None else "K15"
    stages = [("stem", lambda x: fc._stem(packed, x))]
    for s, b, k in stage_blocks(config.vision_layers, 0,
                                sum(config.vision_layers)):
        if s and b == 0:
            stages.append((f"stage {s} downsample",
                           lambda x, s=s: down(x, s)))
        stages.append((f"stage {s} dwconv", lambda x, k=k: dwconv(x, k)))
        stages.append((f"stage {s} {kernel}",
                       lambda xy, s=s, b=b, k=k: mlp(xy, s, b, k)))
    stages.append(("head (pool, head_norm, proj)",
                   lambda x: fc._head(packed, x, project=True)[1]))
    return stages


def convnext_path(bk):
    """5d. ``ClassifierEngine("random:convnext_base_w")``, bf16 and
    ``quantize="int8"`` (a second draw of the same seeded weights), each
    answering the same single-image requests through ``DynamicBatcher``:
    per batch 36 K7, or 36 K15 and no K7; features against the fp32 tower
    (TF32 off) and, for int8, against the same encode with every kernel
    plain; the spread of the batch's features; the batch-64 split; images/s.
    Returns ({path: launch counts}, {rate: images/s}, figures, the bf16
    engine)."""
    import torch

    from aihab_clip_tpu_torch.models.fast_vit import encode_image_fastest
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    layers = sum(CX_DEPTHS)

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    images = np.random.default_rng(SEED + 4).integers(
        0, 256, (CX_REQUESTS, CX_RES, CX_RES, 3), dtype=np.uint8)
    batch = torch.from_numpy(images[:B]).to(dev)
    run_counts, rates, figures, engines = {}, {}, {}, {}
    for path, quantize in (("convnext", "none"), ("convnext_int8", "int8")):
        t0 = time.perf_counter()
        engine = engines[path] = ClassifierEngine(
            model=CX_MODEL, batch_size=64, quantize=quantize, device="cuda")
        engine.warmup()
        cfg = engine.bundle.config
        check((cfg.vision_layers, cfg.vision_width, cfg.image_resolution,
               engine.decode_dim) == (CX_DEPTHS, 128, CX_RES, CX_RES),
              f"config {cfg}")
        print(f"[{path}] {CX_MODEL} quantize={quantize!r}: built + warm in "
              f"{time.perf_counter() - t0:.1f}s")
        bk.reset_launch_counts()
        qm.reset_launch_counts()
        batcher = DynamicBatcher(engine, max_wait_ms=5.0)
        batcher.start()
        t0 = time.perf_counter()
        futures = [batcher.submit(img) for img in images]
        probs = np.stack([f.result(timeout=600) for f in futures])
        wall = time.perf_counter() - t0
        batcher.stop()
        run = run_counts[path] = counts()
        n = batcher.stats.batches
        print(f"[{path}] {len(futures)} requests answered in {wall:.3f}s over "
              f"{n} batches; launches {run}")
        check(probs.shape == (CX_REQUESTS, 20), f"probs shape {probs.shape}")
        check(bool(np.isfinite(probs).all()), "non-finite probabilities")
        check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)),
              "rows not softmax")
        k15 = quantize == "int8"
        want = {"convnext_mlp_block": 0 if k15 else layers * n,
                "ln_gemm": 0 if k15 else layers * n,
                "gemm_residual": 0 if k15 else layers * n,
                "quant_convnext_mlp_block": layers * n if k15 else 0,
                "row_quant": layers * n if k15 else 0,
                "int8_gemm": 2 * layers * n if k15 else 0,
                "full_block_fused": 0, "quant_full_block_fused": 0}
        for key, v in want.items():
            check(run[key] == v, f"{path}: {key} launched {run[key]} times "
                  f"for {n} batches (want {v})")
        figures[f"{path}_probs"] = probs

    eng, eng8 = engines["convnext"], engines["convnext_int8"]
    model, cfg = eng.bundle.model, eng.bundle.config
    check(torch.equal(model.visual.stem_conv.weight,
                      eng8.bundle.model.visual.stem_conv.weight),
          "the int8 engine's draw of the seeded weights differs")
    ref_tower = copy.copy(model.visual)
    ref_tower.dtype = torch.float32
    with torch.inference_mode():
        xb = eval_transform(batch, CX_RES, dtype=torch.bfloat16)
        ref_feats = ref_tower(eval_transform(batch, CX_RES), project=True)[1]
        feats = encode_image_fastest(model, xb, cfg, project=True,
                                     packed=eng._packed)[1].float()
        feats8 = eng8._encode_int8(xb).float()
        with plain_int8_kernels():
            plain8 = eng8._encode_int8(xb).float()
        f = torch.nn.functional.normalize(ref_feats, dim=-1)
        spread = ((f @ f.T).sum() - B) / (B * B - B)
        figures["feature_spread"] = spread.item()
        print(f"[convnext] mean pairwise cosine of the fp32 tower's {B} "
              f"features {spread.item():.4f} (a collapsed random tower "
              "would read ~1)")
        for name, got, other, lim in (
                ("bf16 K7 vs the fp32 tower", feats, ref_feats, COS_MIN),
                ("int8 K15 vs the same encode with every kernel plain",
                 feats8, plain8, INT8_COS["plain"]),
                ("int8 K15 vs the fp32 tower", feats8, ref_feats,
                 INT8_COS["fp32"])):
            cos = torch.nn.functional.cosine_similarity(got, other, dim=-1)
            figures[name] = cos.min().item()
            print(f"[convnext] features, {name} ({B} images): cosine min "
                  f"{cos.min().item():.6f} mean {cos.mean().item():.6f} "
                  f"(limit {lim})")
            check(cos.min().item() >= lim, f"ConvNeXt cosine, {name}")
    p, p8 = figures.pop("convnext_probs"), figures.pop("convnext_int8_probs")
    figures["top1_int8_vs_bf16"] = float((p.argmax(-1) == p8.argmax(-1)).mean())
    print(f"[convnext int8] top-1 agreement with the bf16 engine: "
          f"{figures['top1_int8_vs_bf16']:.4f} over {CX_REQUESTS}, max|dprob| "
          f"{np.abs(p - p8).max():.4g}")

    for path, engine in engines.items():
        qmlp = engine._qparams if path == "convnext_int8" else None
        split, t_all = classify_split(
            engine, batch, convnext_stages(engine._packed, cfg, qmlp),
            iters=3)
        figures[f"{path}_classify_ms"] = t_all
        figures[f"{path}_split_ms"] = split
        print(f"[{path}] batch 64 device time: classify {t_all:.3f} ms; its "
              f"stages in one run {sum(split.values()):.3f} = " + " + ".join(
                  f"{k} {v:.3f}" for k, v in split.items()))
        rates[f"{CX_MODEL.split(':')[1]}{'_int8' if qmlp else ''}_64"] = \
            rate = images_per_s(engine, 64, CX_RES, n=5)
        print(f"[{path}] classify_batch end-to-end at batch 64: {rate:.1f} "
              f"images/s")
    del engines, eng8, ref_tower, batch, xb
    torch.cuda.empty_cache()
    return run_counts, rates, figures, eng


def convnext_peft_path(model, bk):
    """6d. The default fine-tune on ConvNeXt base_w at 256 (``configs/
    base.yaml`` + ``cs.yaml``: batch 16 from 439x439 uint8, random crop +
    rotation, tune_text, unlocked_groups 11, unlocked_layers 1, lr_v 5e-5,
    bf16 over fp32 Adam) with the default ``fused_prefix`` (26 blocks): one
    train step against plain kernels and against the fp32 tower (TF32 off),
    26 K7 per step; the ``prefix_quant`` step runs the same bf16 prefix, as
    in JAX; the step's device time; then ``finetune`` itself.  Trains
    ``model`` in place; returns the figures."""
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import build_text_head
    from aihab_clip_tpu_torch.models import fast_convnext as fc
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _pack_prefix, _quantize_prefix, build_lock_mask,
        finetune, make_train_step, peft_fused_prefix_len)

    dev = torch.device("cuda")
    mcfg = model.config
    layers = sum(mcfg.vision_layers)

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        qm.reset_launch_counts()

    n_prefix = peft_fused_prefix_len(mcfg, PEFT_UNLOCKED, dev)
    check(n_prefix == CX_PEFT_PREFIX, f"ConvNeXt fused prefix {n_prefix}")
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    tokens = build_text_head(model, prompts, 20, tpc)["prompt_tokens"]
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=PEFT_LR, epochs=1, crop_mode="random", rotation=True,
                     tune_text=True, num_templates=tpc,
                     compute_dtype=torch.bfloat16)
    mask = build_lock_mask(model, mcfg.vision_layers, mcfg.transformer_layers,
                           unlocked_groups=PEFT_UNLOCKED, tune_text=True,
                           unlocked_text_layers=1)
    trainable = [(n, p) for n, p in model.named_parameters() if mask[n]]
    print(f"[convnext peft] {len(trainable)} trainable leaves, "
          f"{sum(p.numel() for _, p in trainable):,} parameters; fused prefix "
          f"{n_prefix} (default fused_prefix), suffix {layers - n_prefix} "
          "blocks")

    n_all = sum(CX_PEFT_SPLITS)
    ds = synthetic_dataset(np.random.default_rng(SEED + 5), n_all,
                           PEFT_DECODE)
    n_tr, _, n_te = CX_PEFT_SPLITS
    train_view = SplitView(ds, np.arange(n_tr), PEFT_B, shuffle=True,
                           seed=SEED)
    test_view = SplitView(ds, np.arange(n_tr, n_all), PEFT_B)
    batch = next(train_view.batches(0))
    imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
        batch.images, batch.labels, batch.valid))
    step_grads = step_grads_fn(model, trainable, tokens, imgs, labs, valid)

    cfg_p = dataclasses.replace(cfg, fused_prefix=n_prefix)
    pprefix = _pack_prefix(model, cfg_p)
    check(len(pprefix["blocks"]) == n_prefix, "the K7 prefix pack")
    reset()
    kern = step_grads(cfg_p, pprefix)
    per_step = counts()
    print(f"[convnext peft] launches in one step: {per_step}")
    check(per_step["convnext_mlp_block"] == n_prefix
          and per_step["quant_convnext_mlp_block"] == 0, "K7 launches per step")
    with mock.patch.object(fc, "convnext_mlp_block",
                           bk.convnext_mlp_block_plain):
        reset()
        plain = step_grads(cfg_p, pprefix)
        check(not any(counts().values()), f"plain step launched {counts()}")
    vis_dt, txt_dt = model.visual.dtype, model.text.dtype
    model.visual.dtype = model.text.dtype = torch.float32
    try:
        fp32 = step_grads(dataclasses.replace(
            cfg, compute_dtype=torch.float32, fused_prefix=0), None)
    finally:
        model.visual.dtype, model.text.dtype = vis_dt, txt_dt
    gates = {name: check_step("convnext peft", name, kern, ref,
                              STEP_GATES[name])
             for name, ref in (("plain", plain), ("fp32", fp32))}

    # prefix_quant: no int8 ConvNeXt prefix (JAX peft.py:280-281), the bf16
    # prefix runs
    cfg8 = dataclasses.replace(cfg_p, prefix_quant=True)
    check(_quantize_prefix(model, cfg8) is None
          and len(_pack_prefix(model, cfg8)["blocks"]) == n_prefix,
          "prefix_quant packs the bf16 prefix")
    reset()
    same = step_grads(cfg8, _pack_prefix(model, cfg8))
    per_step_q = counts()
    print(f"[convnext peft] launches in one prefix_quant step: {per_step_q}")
    check(per_step_q["convnext_mlp_block"] == n_prefix
          and per_step_q["quant_convnext_mlp_block"] == 0,
          "prefix_quant runs the bf16 K7 prefix")
    gates["prefix_quant"] = check_step("convnext peft", "the prefix_quant "
                                       "step", same, kern, STEP_GATES["plain"])
    model.zero_grad(set_to_none=True)
    del kern, plain, fp32, same

    torch.cuda.reset_peak_memory_stats()
    _, step = make_train_step(model, cfg_p, None, tokens)
    times = timed_steps(step, imgs, labs, valid, pprefix, 1)
    peak = torch.cuda.max_memory_allocated()
    print(f"[convnext peft] train step at batch {PEFT_B}: median "
          f"{statistics.median(times):.3f} ms over {len(times)} steps ("
          f"{', '.join(f'{t:.2f}' for t in times)}), peak memory "
          f"{peak / 2 ** 30:.2f} GiB")

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    reset()
    t0 = time.perf_counter()
    out = finetune(model, train_view, None, test_view, cfg,
                   prompt_tokens=tokens, unlocked_groups=PEFT_UNLOCKED,
                   unlocked_text_layers=1, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = counts()
    steps, eval_batches = n_tr // PEFT_B, n_te // PEFT_B
    print(f"[convnext peft] finetune (fused_prefix=-1): {steps} steps + "
          f"{eval_batches} test batches in {wall:.2f}s; launches {run_counts}")
    check(run_counts["convnext_mlp_block"] == n_prefix * steps
          + layers * eval_batches, "K7 launches in finetune")
    frozen_changed = [n for n, p in model.named_parameters()
                      if not mask[n] and not torch.equal(before[n], p)]
    moved = [n for n, _ in trainable
             if not torch.equal(before[n], out["params"][n])]
    check(not frozen_changed, f"frozen leaves changed: {frozen_changed[:5]}")
    check(len(moved) > 0, "no trainable leaf moved")
    test = out["test"]
    check(int(test["cm"].sum()) == n_te and np.isfinite(test["loss"]),
          "ConvNeXt finetune test")
    print(f"[convnext peft] {len(moved)} of {len(trainable)} trainable "
          f"leaves moved; test loss {test['loss']:.4f} top1 "
          f"{test['top1']:.4f}")
    return dict(step_ms=statistics.median(times), step_ms_all=times,
                peak_gib=peak / 2 ** 30, step_checks=gates, finetune_s=wall,
                test_loss=test["loss"])


def large_vit_kernel_cases(rnd, vec, run_cases) -> None:
    """3h. The kernels of the LAION towers' paths at ViT-g/14's and
    ViT-bigG/14's shapes, batch 64, S = 257 (W = 1408 and 1664, 16 heads of
    88 and 104, hidden 6144 and 8192, gelu_poly), each against its plain
    version: the attention in its four forms (packed bf16 as K1 runs it;
    grouped and q-scaled as K5 runs it, in bf16, and as K13 runs it, in
    fp32; P normalised as K12 and K14 run it), each beside SDPA at its
    shape; K1; JAX's bf16 route K5 + K4 (``JAX_ROUTES``); K14; JAX's int8
    route K13 + one slice of the chained K9 -> K10; and K8 over the patch-14
    im2col (K = 588, padded to 592), bit for bit."""
    import torch

    from aihab_clip_tpu_torch.models.clip import CLIP_ARCHS
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    f32 = torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5, dtype=f32))
        return qm.int8_weight(w8), ws

    for arch in ("ViT-g/14", "ViT-bigG/14"):
        cfg, route = CLIP_ARCHS[arch], JAX_ROUTES[arch]
        tag = LARGE_TAGS[arch]
        w, heads, hid = cfg.vision_width, cfg.vision_heads, cfg.vision_mlp_dim
        d, s = w // heads, LARGE_S
        m = B * s
        groups, chunks = route["groups"], route["chunks"]
        igroups, ich = route["int8_groups"], route["int8_chunks"]
        check(igroups == groups, "K5 and K13 share the grouped qkv here")
        x = rnd(B, s, w)
        x2 = x.reshape(m, w)
        ln1, ln2 = (vec(w, one=True), vec(w)), (vec(w, one=True), vec(w))
        p = dict(ln1_scale=ln1[0], ln1_bias=ln1[1],
                 w_qkv=rnd(w, 3 * w, scale=w ** -0.5), b_qkv=vec(3 * w),
                 w_out=rnd(w, w, scale=w ** -0.5), b_out=vec(w),
                 ln2_scale=ln2[0], ln2_bias=ln2[1],
                 w_fc=rnd(w, hid, scale=w ** -0.5), b_fc=vec(hid),
                 w_proj=rnd(hid, w, scale=hid ** -0.5), b_proj=vec(w))
        wg, bg, og = bk.regroup_attn_weights_f(p["w_qkv"], p["b_qkv"],
                                               p["w_out"], heads, groups)
        wg_flat = wg.permute(1, 0, 2).reshape(w, -1).contiguous()
        # the attention's inputs as each route's qkv GEMM makes them
        qkv = bk.ln_gemm(x2, *ln1, p["w_qkv"], p["b_qkv"]).reshape(B, s, -1)
        qkv_g = bk.ln_gemm(x2, *ln1, wg_flat, bg.reshape(-1),
                           q_scale=d ** -0.5, q_width=w // groups).reshape(
                               B, s, -1)
        qkv_s = bk.ln_gemm(x2, *ln1, p["w_qkv"], p["b_qkv"], q_scale=d ** -0.5,
                           q_width=w).reshape(B, s, -1)
        sq, sk, sv = (t.reshape(B, s, heads, d).transpose(1, 2)
                      for t in qkv.split(w, -1))
        wq8, sq8 = weight(w, 3 * w)
        wo8, so8 = weight(w, w)
        w18, s18 = weight(w, hid)
        w28, s28 = weight(hid, w)
        attn8 = (wq8, sq8, vec(3 * w), wo8, so8, vec(w), *ln1)
        mlp8 = (w18, s18, vec(hid), w28, s28, vec(w))
        k14 = (*attn8, *mlp8, *ln2, heads)
        rg = qm.regroup_attn_weights(wq8, sq8, attn8[2], wo8, heads, igroups)
        wg8, og8 = qm.int8_attn_weights(rg[0], rg[3])
        k13 = (wg8, rg[1], rg[2], og8, so8, attn8[5], *ln1, heads, igroups)
        sl = slice(0, hid // ich)
        k9 = (w18[:, sl], s18[sl], mlp8[2][sl], *ln2)
        h8, hs = qm.quant_matmul_fused_qout(x2, *k9, act="gelu_poly")
        k10 = (h8, hs, w28[sl], s28, mlp8[5], x2)
        l8, sl8 = qm.row_quant(x2, *ln2)   # K14's c_fc input, as LN2 makes it
        c_fc = (l8, sl8, w18.t(), s18, mlp8[2])
        kp = 14 * 14 * 3
        patches = rnd(B * 256, kp)
        wp8, sp = weight(kp, w)
        bp = torch.zeros(w, device=x.device)
        f_att = 4 * B * heads * s * s * d
        f_qkv, f_out, f_mlp = 2 * m * w * 3 * w, 2 * m * w * w, 4 * m * w * hid
        att_bytes = 2 * m * 3 * w + 2 * m * w
        print(f"[kernels] {arch}: B={B} S={s} W={w} {heads}x{d} hidden "
              f"{hid}; per block {(f_qkv + f_out + f_mlp + f_att) / 1e9:.1f} "
              f"GFLOP, {f_att / 1e9:.1f} of them attention; JAX's routes: K5 "
              f"over {groups} groups + K4 over {chunks} chunks, K13 over "
              f"{igroups} groups + K9 -> K10 over {ich} slices")

        def att_case(label, replaces, q, path, lib, **kw):
            return (f"attention[{arch} hd{d}, {label}]", replaces,
                    "attention", lambda: bk.attention(q, heads, **kw),
                    lambda: bk.attention_plain(q, heads, **kw), lib, f_att,
                    att_bytes + (2 * m * w if kw.get("out_dtype") else 0),
                    bk.attention, path)

        def sdpa_call():
            return sdpa(sq, sk, sv)

        run_cases([
            att_case("packed, bf16 out", f"{JAX_BK}:896", qkv, tag,
                     sdpa_call),
            att_case(f"{groups} groups, q-scaled, bf16 out", f"{JAX_BK}:861",
                     qkv_g, tag + "_jax", sdpa_call, group_heads=heads // groups,
                     q_scaled=True),
            att_case(f"{igroups} groups, q-scaled, fp32 out",
                     f"{JAX_QM}:590", qkv_g, tag + "_int8_jax", sdpa_call,
                     group_heads=heads // igroups, q_scaled=True,
                     out_dtype=f32),
            att_case("one group, q-scaled, fp32 out, P normalised",
                     f"{JAX_QM}:748", qkv_s, tag + "_int8", sdpa_call,
                     q_scaled=True, out_dtype=f32, normalize_p=True),
            (f"full_block_fused[{arch}]", f"{JAX_BK}:1056", "block",
             lambda: bk.full_block_fused(x, **p, heads=heads, act="gelu_poly"),
             lambda: bk.full_block_fused_plain(x, **p, heads=heads,
                                               act="gelu_poly"),
             None, f_qkv + f_out + f_mlp + f_att,
             4 * m * w + 2 * (4 * w * w + 2 * w * hid), bk.full_block_fused,
             tag),
            (f"attn_block_split[{arch}, {groups} groups]", f"{JAX_BK}:834",
             "block",
             lambda: bk.attn_block_split(x, wg, bg, og, p["b_out"], *ln1,
                                         heads, groups),
             lambda: bk.attn_block_split_plain(x, wg, bg, og, p["b_out"],
                                               *ln1, heads, groups),
             None, f_qkv + f_out + f_att, 4 * m * w + 2 * 4 * w * w,
             bk.attn_block_split, tag + "_jax"),
            (f"mlp_block_split[{arch}, {chunks} chunks]", f"{JAX_BK}:525",
             "block",
             lambda: bk.mlp_block_split(x2, *ln2, p["w_fc"], p["b_fc"],
                                        p["w_proj"], p["b_proj"],
                                        n_chunks=chunks, act="gelu_poly"),
             lambda: bk.mlp_block_split_plain(x2, *ln2, p["w_fc"], p["b_fc"],
                                              p["w_proj"], p["b_proj"],
                                              n_chunks=chunks,
                                              act="gelu_poly"),
             None, f_mlp, 4 * m * w + 2 * 2 * w * hid, bk.mlp_block_split,
             tag + "_jax"),
            (f"quant_full_block_fused[{arch}]", f"{JAX_QM}:794", "int8_block",
             lambda: qm.quant_full_block_fused(x, *k14, act="gelu_poly"),
             lambda: qm.quant_full_block_fused_plain(x, *k14,
                                                     act="gelu_poly"),
             None, (f_att, f_qkv + f_out + f_mlp),
             4 * m * w + 4 * w * w + 2 * w * hid + 8 * (5 * w + hid),
             qm.quant_full_block_fused, tag + "_int8", SRC_Q),
            (f"int8_gemm[{arch} c_fc, gelu_poly, quantized out]",
             f"{JAX_QM}:781", "codes",
             lambda: qm.int8_gemm(*c_fc, act="gelu_poly",
                                  out_dtype=torch.int8),
             lambda: qm.int8_gemm_plain(*c_fc, act="gelu_poly",
                                        out_dtype=torch.int8),
             None, (0, f_mlp // 2), m * w + 4 * m + w * hid + 8 * hid
             + m * hid + 4 * m, qm.int8_gemm, tag + "_int8", SRC_Q),
            (f"quant_attn_block_split[{arch}, {igroups} groups]",
             f"{JAX_QM}:622", "int8_block",
             lambda: qm.quant_attn_block_split(x, *k13),
             lambda: qm.quant_attn_block_split_plain(x, *k13), None,
             (f_att, f_qkv + f_out), 4 * m * w + 4 * w * w + 20 * w,
             qm.quant_attn_block_split, tag + "_int8_jax", SRC_Q),
            (f"quant_matmul_fused_qout[{arch} c_fc, 1 of {ich} slices]",
             f"{JAX_QM}:130", "codes",
             lambda: qm.quant_matmul_fused_qout(x2, *k9, act="gelu_poly"),
             lambda: qm.quant_matmul_fused_qout_plain(x2, *k9,
                                                      act="gelu_poly"),
             None, (0, f_mlp // 2 // ich),
             2 * m * w + w * hid // ich + 8 * (w + hid // ich)
             + m * hid // ich + 4 * m, qm.quant_matmul_fused_qout,
             tag + "_int8_jax", SRC_Q),
            (f"quant_matmul_q8in[{arch} c_proj, 1 of {ich} slices]",
             f"{JAX_QM}:165", "kernel",
             lambda: qm.quant_matmul_q8in(*k10),
             lambda: qm.quant_matmul_q8in_plain(*k10), None,
             (0, f_mlp // 2 // ich),
             m * hid // ich + 4 * m + hid // ich * w + 8 * w + 4 * m * w,
             qm.quant_matmul_q8in, tag + "_int8_jax", SRC_Q),
            (f"quant_matmul_fused[{arch} patch 14, K 588 in 592]",
             f"{JAX_QM}:376", "exact",
             lambda: qm.quant_matmul_fused(patches, wp8, sp, bp),
             lambda: qm.quant_matmul_fused_plain(patches, wp8, sp, bp), None,
             (0, 2 * B * 256 * kp * w),
             2 * B * 256 * kp + kp * w + 8 * w + 2 * B * 256 * w,
             qm.quant_matmul_fused, tag + "_int8", SRC_Q),
        ])
        k1_ms = 1e3 * (f_qkv + f_out + f_mlp + f_att) / PEAK_FLOPS
        k14_ms = 1e3 * ((f_qkv + f_out + f_mlp) / PEAK_INT8_OPS
                        + f_att / PEAK_FLOPS)
        print(f"[kernels] {arch} bound per block at batch {B}: K1 "
              f"{k1_ms:.4f} ms, {cfg.vision_layers} blocks "
              f"{cfg.vision_layers * k1_ms:.3f} ms; K14 {k14_ms:.4f} ms")
        del x, x2, qkv, qkv_g, qkv_s, sq, sk, sv, h8, patches, p, wg, og, l8
        del c_fc
        torch.cuda.empty_cache()


def large_vit_paths(bk):
    """5f. The LAION towers at full size (random weights from seed 0):
    ViT-H/14 bf16, ViT-g/14 and ViT-bigG/14 bf16 and int8, each engine
    answering ``LARGE_REQUESTS`` single 224x224 requests through
    ``DynamicBatcher`` (the bf16 engines by their open_clip names).  Per
    engine: its launches per batch (bf16: one K1 a block; int8: one K8 and
    one K14 a block), its features against the fp32 tower (the same
    parameters computing in fp32, ``LARGE_REF_B`` images) and, int8, against
    the same encode with every kernel plain; the batch-64 split; images/s.
    ViT-g and ViT-bigG also run JAX's routes (``JAX_ROUTES``: K5 + K4, and
    K13 + the chained K9 -> K10, composed from the encode's stages over
    ``split_block_plan`` / ``split_int8_plan``) with their launches and
    their cosine against the default route.  The ViT-H/14 bf16 engine also
    serves under ``AIHAB_NO_GELU_POLY=1``, set only around it: the same
    requests, per block K2 + ``ln_matmul(gelu)`` (plain, as JAX) + K16
    ``matmul_residual``; features and probabilities against the same encode
    with plain kernels; images/s.  Each tower is freed before the next one
    loads.  Returns ({path: launch counts}, {rate: images/s}, figures)."""
    import os
    from unittest import mock

    import torch

    import aihab_clip_tpu_torch.models as models
    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.models import quant_vit as qv
    from aihab_clip_tpu_torch.models.fast_vit import _ln
    from aihab_clip_tpu_torch.ops import fused_linear as fl
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    cos = torch.nn.functional.cosine_similarity
    images = np.random.default_rng(SEED + 5).integers(
        0, 256, (LARGE_REQUESTS, 224, 224, 3), dtype=np.uint8)
    batch = torch.from_numpy(images[:B]).to(dev)
    counts, rates, figures = {}, {}, {}

    def launches():
        return {**bk.launch_counts(), **qm.launch_counts(),
                **fl.launch_counts()}

    def reset():
        for mod in (bk, qm, fl):
            mod.reset_launch_counts()

    def split_encode(packed, t, cfg, plan):
        """JAX's bf16 route: embed, K5 + K4 per block, ln_post(CLS), proj."""
        x = fast_vit._apply_fused_blocks(
            packed, fast_vit._vit_embed(packed, t, cfg), plan, start=0,
            stop=cfg.vision_layers)
        return _ln(x[:, 0, :], *packed["ln_post"]) @ packed["proj"]

    def split_encode_int8(qp, t, cfg, plan):
        """JAX's int8 route: K8, K13 + K9 -> K10 per block, ln_post(CLS),
        proj."""
        x = qv.apply_int8_vit_blocks(
            qp["transformer"], qv.vit_patchify_int8(qp, t, cfg), cfg,
            start=0, stop=cfg.vision_layers, plan=plan)
        pre = _ln(x[:, 0, :], qp["ln_post"]["scale"], qp["ln_post"]["bias"])
        return pre @ qp["proj"].to(pre.dtype)

    def gelu_optout(eng, arch, fig):
        """The exact-gelu opt-out on a gelu tower's bf16 engine."""
        cfg, layers = eng.bundle.config, eng.bundle.config.vision_layers
        tag = f"{arch} bf16 under AIHAB_NO_GELU_POLY=1"
        with mock.patch.dict(os.environ, {"AIHAB_NO_GELU_POLY": "1"}):
            eng.warmup()
            run, n, _ = serve(eng, tag)
            check(run["attn_block_fused"] == layers * n
                  and run["matmul_residual"] == layers * n
                  and run["ln_matmul"] == 0
                  and run["full_block_fused"] == run["mlp_block_fused"] == 0,
                  f"{tag}: launches")
            with torch.inference_mode():
                xb = eval_transform(batch, 224, dtype=torch.bfloat16)

                def feats_and_probs():
                    return (fast_vit.vit_encode_block_fused(
                        eng._packed, xb, cfg, project=True)[1].float(),
                        eng.classify(batch))

                g_k, p_k = feats_and_probs()
                with mock.patch.multiple(
                        fast_vit, attn_block_fused=bk.attn_block_fused_plain,
                        matmul_residual=fl.matmul_residual_plain):
                    g_p, p_p = feats_and_probs()
            dprob = (p_k - p_p).abs().max().item()
            agree = (p_k.argmax(-1) == p_p.argmax(-1)).float().mean().item()
            fig["optout_cos_min"] = gate(tag, "plain kernels", g_k, g_p,
                                         COS_MIN)
            rate = images_per_s(eng, B, 224)
        print(f"[large] {tag}: max|dprob| vs plain kernels {dprob:.4g}; "
              f"top-1 agreement {agree:.4f}; classify_batch at batch {B}: "
              f"{rate:.1f} images/s")
        fig.update(optout_dprob=dprob, optout_top1=agree)
        return run, rate

    def build(name, **kw):
        """The engine and the seconds its ``load`` took (the random weights
        are drawn on the host)."""
        seconds = []
        real = models.load

        def timed_load(*a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out

        t0 = time.perf_counter()
        with mock.patch.object(models, "load", timed_load):
            eng = ClassifierEngine(model=name, batch_size=B, device="cuda",
                                   verbose=False, **kw)
        eng.warmup()
        print(f"[large] {name}{' int8' if kw else ''}: load {seconds[0]:.1f}s"
              f" (random weights drawn on the host), engine built + warm in "
              f"{time.perf_counter() - t0:.1f}s")
        return eng, seconds[0]

    def serve(eng, tag):
        reset()
        batcher = DynamicBatcher(eng, max_wait_ms=5.0)
        batcher.start()
        t0 = time.perf_counter()
        futures = [batcher.submit(img) for img in images]
        probs = np.stack([f.result(timeout=900) for f in futures])
        wall = time.perf_counter() - t0
        batcher.stop()
        run, n = launches(), batcher.stats.batches
        print(f"[large] {tag}: {len(futures)} requests in {wall:.3f}s over "
              f"{n} batches; launches {run}")
        check(probs.shape == (LARGE_REQUESTS, 20)
              and bool(np.isfinite(probs).all())
              and bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)),
              f"{tag} probabilities")
        return run, n, probs

    def fp32_feats(model):
        tower = copy.copy(model.visual)
        tower.dtype = torch.float32
        with torch.inference_mode():
            return tower(eval_transform(batch[:LARGE_REF_B], 224),
                         project=True)[1]

    def gate(tag, name, feats, ref, limit):
        c = cos(feats[:ref.shape[0]].float(), ref.float(), dim=-1)
        print(f"[large] {tag} features vs {name}: cosine min "
              f"{c.min().item():.6f} mean {c.mean().item():.6f} (limit "
              f"{limit})")
        check(c.min().item() >= limit, f"{tag} cosine vs {name}")
        return c.min().item()

    for arch, dashed in LARGE_MODELS.items():
        tag = LARGE_TAGS[arch]
        fig = figures[tag] = {}
        # ---- bf16, by the open_clip name
        eng, fig["load_s"] = build(f"random:{dashed}")
        cfg, packed = eng.bundle.config, eng._packed
        layers = cfg.vision_layers
        check(eng.bundle.name == f"random:{arch}", "dashed name resolution")
        run, n, probs = serve(eng, f"{arch} bf16 ({dashed})")
        counts[tag] = run
        for key in ("full_block_fused", "attention"):
            check(run[key] == layers * n, f"{arch}: {key} launched {run[key]}"
                  f" times for {n} batches (want {layers} each)")
        check(run["attn_block_split"] == run["mlp_block_split"] == 0,
              f"{arch}: split kernels on the default route")
        ref = fp32_feats(eng.bundle.model)
        with torch.inference_mode():
            xb = eval_transform(batch, 224, dtype=torch.bfloat16)
            feats = fast_vit.vit_encode_block_fused(packed, xb, cfg,
                                                    project=True)[1]
            fig["cos_fp32_min"] = gate(f"{arch} bf16", "the fp32 tower",
                                       feats, ref, COS_MIN)
            if arch != "ViT-H/14":
                route = JAX_ROUTES[arch]
                plan = fast_vit.split_block_plan(cfg, route["groups"],
                                                 route["chunks"])
                reset()
                jax_feats = split_encode(packed, xb, cfg, plan)
                torch.cuda.synchronize()
                jrun = counts[tag + "_jax"] = launches()
                print(f"[large] {arch} JAX's route (K5 over {route['groups']}"
                      f" groups, K4 over {route['chunks']} chunks): launches "
                      f"{jrun}")
                check(jrun["attn_block_split"] == layers
                      and jrun["mlp_block_split"] == layers
                      and jrun["full_block_fused"] == 0,
                      f"{arch} JAX route launches")
                fig["jax_cos_default_min"] = gate(
                    f"{arch} JAX route", "the default route (K1)", jax_feats,
                    feats, COS_MIN)
                fig["jax_cos_fp32_min"] = gate(f"{arch} JAX route",
                                               "the fp32 tower", jax_feats,
                                               ref, COS_MIN)
                split, _ = staged_ms(xb, [("k5_k4", lambda t: (
                    split_encode(packed, t, cfg, plan)))])
                fig["jax_encode_ms"] = split["k5_k4"]
        split, t_all = classify_split(eng, batch, [
            ("encode", lambda x: fast_vit.vit_encode_block_fused(
                packed, x, cfg, project=True)[1])])
        fig.update(classify_ms=t_all, encode_ms=split["encode"])
        rates[f"{tag}_64"] = images_per_s(eng, B, 224)
        jax_ms = (f"; JAX's route encode {fig['jax_encode_ms']:.3f} ms"
                  if "jax_encode_ms" in fig else "")
        print(f"[large] {arch} bf16 batch {B} device time: classify "
              f"{t_all:.3f} ms = eval_transform {split['eval_transform']:.3f}"
              f" + encode ({layers} K1) {split['encode']:.3f} + head "
              f"{split['head']:.3f}{jax_ms}; classify_batch "
              f"{rates[f'{tag}_64']:.1f} images/s")
        if arch == "ViT-H/14":
            counts[tag + "_nogelupoly"], rates[f"{tag}_gelu_optout_64"] = \
                gelu_optout(eng, arch, fig)
        del eng, packed, feats, xb
        torch.cuda.empty_cache()
        if arch == "ViT-H/14":
            continue

        # ---- int8, by the table's name
        eng, fig["int8_load_s"] = build(f"random:{arch}", quantize="int8")
        qp = eng._qparams
        run, n, probs8 = serve(eng, f"{arch} int8")
        counts[tag + "_int8"] = run
        want = {"quant_matmul_fused": n, "quant_full_block_fused": layers * n,
                "quant_attn_block_split": 0, "quant_matmul_fused_qout": 0,
                "full_block_fused": 0}
        for key, v in want.items():
            check(run[key] == v, f"{arch} int8: {key} launched {run[key]} "
                  f"times for {n} batches (want {v})")
        fig["top1_vs_bf16"] = float((probs8.argmax(-1)
                                     == probs.argmax(-1)).mean())
        with torch.inference_mode():
            xb = eval_transform(batch, 224, dtype=torch.bfloat16)
            feats8 = qv.vit_encode_int8(qp, xb, cfg, project=True)[1]
            with plain_int8_kernels():
                plain = qv.vit_encode_int8(qp, xb, cfg, project=True)[1]
            fig["int8_cos_plain_min"] = gate(f"{arch} int8",
                                             "all-plain kernels", feats8,
                                             plain, INT8_COS["plain"])
            fig["int8_cos_fp32_min"] = gate(f"{arch} int8", "the fp32 tower",
                                            feats8, ref, INT8_COS["fp32"])
            route = JAX_ROUTES[arch]
            iplan = qv.split_int8_plan(cfg, route["int8_groups"],
                                       route["int8_chunks"])
            reset()
            jax8 = split_encode_int8(qp, xb, cfg, iplan)
            torch.cuda.synchronize()
            jrun = counts[tag + "_int8_jax"] = launches()
            ich = route["int8_chunks"]
            print(f"[large] {arch} JAX's int8 route (K13 over "
                  f"{route['int8_groups']} groups, K9 -> K10 over {ich} "
                  f"slices): launches {jrun}")
            check(jrun["quant_attn_block_split"] == layers
                  and jrun["quant_matmul_fused_qout"] == layers * ich
                  and jrun["quant_matmul_q8in"] == layers * ich
                  and jrun["quant_matmul_fused"] == 1
                  and jrun["quant_full_block_fused"] == 0,
                  f"{arch} JAX int8 route launches")
            fig["int8_jax_cos_default_min"] = gate(
                f"{arch} JAX int8 route", "the default int8 route (K14)",
                jax8, feats8, INT8_COS["fp32"])
            fig["int8_jax_cos_fp32_min"] = gate(
                f"{arch} JAX int8 route", "the fp32 tower", jax8, ref,
                INT8_COS["fp32"])
        split, t_all = classify_split(eng, batch, [
            ("k8", lambda x: qv.vit_patchify_int8(qp, x, cfg)),
            ("blocks", lambda t: qv.apply_int8_vit_blocks(
                qp["transformer"], t, cfg, start=0, stop=layers)),
            ("ln_post_proj", lambda t: _ln(
                t[:, 0, :], qp["ln_post"]["scale"], qp["ln_post"]["bias"])
                @ qp["proj"].to(t.dtype))])
        with torch.inference_mode():
            jsplit, _ = staged_ms(xb, [("k13_k9_k10", lambda t: (
                split_encode_int8(qp, t, cfg, iplan)))])
        fig.update(int8_classify_ms=t_all, int8_k8_ms=split["k8"],
                   int8_blocks_ms=split["blocks"],
                   int8_jax_encode_ms=jsplit["k13_k9_k10"])
        rates[f"{tag}_int8_64"] = images_per_s(eng, B, 224)
        print(f"[large] {arch} int8 batch {B} device time: classify "
              f"{t_all:.3f} ms = eval_transform {split['eval_transform']:.3f}"
              f" + K8 {split['k8']:.3f} + {layers} K14 {split['blocks']:.3f} "
              f"+ ln_post/proj {split['ln_post_proj']:.3f} + head "
              f"{split['head']:.3f}; JAX's int8 route encode "
              f"{jsplit['k13_k9_k10']:.3f} ms; classify_batch "
              f"{rates[f'{tag}_int8_64']:.1f} images/s (bf16 "
              f"{rates[f'{tag}_64']:.1f}); top-1 agreement with bf16 "
              f"{fig['top1_vs_bf16']:.4f}")
        del eng, qp, xb, feats8, plain, jax8, ref
        torch.cuda.empty_cache()
    del batch
    torch.cuda.empty_cache()
    return counts, rates, figures


if __name__ == "__main__":
    main()
