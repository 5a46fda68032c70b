#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``aihab_clip_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases (any failure raises and the exit code is non-zero):
  1. device  — the card's name and power limit (nvidia-smi);
  2. build   — compile every source of ``aihab_clip_tpu_torch/csrc/`` into
     ``build/`` (one nvcc for each ``.cu``, the host compiler for
     ``jpeg_entropy.cpp``, ``zstd_decode.cpp`` and ``blosc_lz4.cpp``, all
     started together) and print the seconds
     and ptxas's register/smem report; then the launch plans of the TMA +
     wgmma kernels at the paths' shapes (registers, local bytes, shared
     bytes a block, ring stages, tiles or blocks and waves): the bf16 GEMM,
     the flash attention, K6b's dq and dk/dv kernels, the int8 GEMM;
     A18 (c): the files JAX wrote (``tests/golden/jax_written``, by
     ``tests/make_jax_written_fixtures.py``), read with the host codecs just
     built: 20 libzstd frames (levels -5 to 22) by the SHA-256 of their
     output, JAX's orbax checkpoint of a ViT tower with its Adam state and a
     TensorStoreStore directory (blosc/LZ4, 8 dtypes) against the arrays
     recorded beside them, bit for bit; the host codecs' GB/s on this
     machine's CPU (zstd decode, the raw-frame writer, XXH64, blosc/LZ4);
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
     fp32 GEMM + row_quant bit for bit), the GEMMs beside ``torch._int_mm``,
     the attention beside SDPA;
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
     5b: the same model with ``quantize="int8"`` (on the bf16 engine's
     seeded weights: the engine takes a model name, as in JAX) answers the
     same requests, per batch 1 K8, 27 K13, 27 K9, 27 K10 and no K4/K5;
     features against the same encode with every kernel plain and against
     the fp32 canonical tower; top-1 agreement with the bf16 engine; the
     batch-64 split; images/s beside the bf16 engine's; then JAX's other
     two int8 routes at batch 64 (A15b), each counted from zero over one
     encode: ``attn_impl="chained"`` (55 K8, 27 K6f, 27 K9, 27 K10) and
     ``impl="xla"`` (``quant_dense`` through ``torch._int_mm``, 27 K6f),
     against the bf16 engine's features and the split route's top-1, with
     device ms and images/s;
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
     197; K18 ``normalize_u8_pallas`` at 64 x 224^2 x 3, bit for bit
     (bf16, fp32, a ragged tail), its device time from a CUDA graph of 100
     launches and its host time a call (``tools/k18_time.measure``);
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
     the int8 GEMMs (K14's c_fc, K9's and K10's slices, K8) beside
     ``torch._int_mm`` at their shapes;
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
     ``matmul_residual``, against plain kernels; then its int8 engine
     under the same variable, which takes JAX's ``xla`` route (A15:
     ``quant_dense`` per GEMM, exact gelu, the plain attention; no kernel
     launch), features against the bf16 exact-gelu engine's
     (``INT8_COS["plain"]``), images/s beside it;
  A17. the LAION towers' default fine-tune step (batch 16 at 224 from
     439x439, unlocked_groups 11, tune_text) on ViT-H/14, ViT-g/14 and
     ViT-bigG/14 at full width and depth, the memory reckoned from the
     configuration first: the K1-prefix step (22 / 30 / 38 K1) against K1
     plain and the fp32 tower (``VIT_STEP_GATES``), the K14-prefix step
     against K14 plain (``INT8_PLAIN_COS``, which the K1-prefix step must
     fail) and against the K1-prefix step, on ViT-H/14 the
     ``scan_blocks`` + ``scan_remat`` step against the unscanned one (D2);
     2 warm-up + 3 timed steps of each, ms and peak GiB, frozen leaves bit
     for bit unchanged; the OpenAI ViT-L/14 and ViT-L/14@336px (S = 577)
     bf16 (24 K1 a batch) and int8 (K8 + 24 K14) engines answering 96
     requests through ``DynamicBatcher`` against K1 plain (``COS_MIN``,
     ``INT8_COS``), images/s, ``cache_features_from_loader`` (2 views of 32
     images), and the same fine-tune step (a 14-block prefix);
     3i: the fast JPEG decode (``ops/jpeg.py``) on a 12 MP (4000 x 3000)
     and 1024 x 768 JPEGs written by the port's encoder and a 1024 x 768
     CMYK and YCCK one by ``tools/jpeg_fixtures.py``: the C++ Huffman
     decoder's coefficients of the 12 MP photo equal data/decode.py's
     pure-Python ones; the card decode at full scale and at m = 2 equals the
     numpy pipeline on them; the photo's progressive re-code (the fixture
     tool) has the same C++ coefficients and card pixels at m = 8 and 2,
     and the host Huffman ms of both; so have its arithmetic-coded re-codes
     (SOF9, SOF10; A9c), their host arithmetic ms beside; the libjpeg-written
     arithmetic fixtures (``tests/golden/jpeg_arith``) through C++ -> J1 ->
     J2 against decode.py's coefficients and JAX's native pixels
     (``reference.npz``); J1 (``jpeg_idct``), J2
     (``jpeg_color_resize``) and J2's four-component instance
     (``jpeg_color_resize_cmyk``) against their plain versions, max|d| 0,
     timed at the 12 MP (full, m = 2), 1024 x 768 and CMYK/YCCK shapes to
     224, then compared at m = 4 and 1 and at 4:2:2, 4:4:4, 4:4:0 and gray;
  8b. serving — ``PredictServer(port=0)`` over the bf16 ViT-B/16 engine: 48
     requests in the three wires (raw, JSON base64, the binary batch) from 8
     urllib client threads, 112 photos (12 MP, 1024 x 768, CMYK and YCCK):
     every answer against ``classify_batch`` of ``decode_bytes`` of the same
     blob (top-1, max|dprob| <= 1e-3), one J1 a request and one launch of
     each J2 instance its photos need, 12 K1 a batch; garbage and a JPEG cut
     in its header counted as decode failures, a 1024 x 768 JPEG re-coded
     arithmetic-coded (SOF9) and one cut in its scan answered with the
     probabilities of ``classify_batch(decode_bytes(blob))`` (JAX's native
     path keeps both); images/s over HTTP,
     latency p50/p99, fill, decode ms per photo split into host (parse +
     C++ Huffman) and card (upload + J1 + J2); 8c: 8 requests through the
     int8 engine (K8 + 12 K14 a batch);
  8. runner — the port's own entry point (``runner.run``, what ``python -m
     aihab_clip_tpu_torch`` calls) on a synthetic CS tree in a temporary
     directory (20 classes, 8 train and 3 test 64 px JPEGs each, written by
     the port's encoder; one train photo re-coded as a progressive JPEG and
     one rewritten as a PNG, so the folder takes JAX's cv2.imread route),
     ``configs/base.yaml`` + ``cs.yaml`` as written
     (the DCT-domain prescale on) with ``RUNNER_OPTS``: ProLIP on ViT-B/16
     (3 cached views through K1, the 7x7 grid search, 5 epochs, the test
     split through K1) held against K1's plain version in fp32, the CPU's
     projector, grid pick and accuracy, K1 launches = 12 x the batches
     encoded; then PEFT (2 epochs) with finite losses and unchanged frozen
     leaves; one more PEFT epoch with ``aug_impl: exact`` (the per-image
     gather augment: one ``train_transform`` a step); Tip-Adapter's search
     on the ProLIP cache (``train/tip_adapter.py``) on the card against the
     CPU (the same best accuracy, logits within 1e-5 rel L2); A18 (b): the
     ProLIP run again with ``root_path file://<tmp>`` (the zarr store,
     blosc/LZ4, as JAX's TensorStoreStore writes it; K1 encodes the views):
     the cached views and labels bit for bit with the ``.npy`` run's, the
     same grid pick, the projector within ``RUNNER_PROJ_REL``, and the
     store's write and read GB/s on the views and on the views tiled to
     ``CACHE_ROWS`` rows; the fast
     decode's ms per 64 px photo and for the 12 MP JPEG at
     full scale and m = 2 (s per megapixel), the predict CLI over the test
     folder against an engine's rows, build_loaders s, cache write and test
     encode images/s, grid search and train_projector s, PEFT s per epoch;
  9. A10 (the remaining fine-tune options): 9d, on the SO400M engine's
     weights, one LoRA train step (rank 8 on both towers' attention,
     ``scan_blocks`` + ``scan_remat``, tune_text, batch 16 at 384): 54 K6
     forward (remat runs each block's forward again) and 27 K6 backward
     launches, the loss and the adapters' gradient against the same step
     with K6 plain (``STEP_GATES``), ms and peak memory with and without
     ``scan_remat``; 9e, ``finetune`` with the same options and
     ``profile_dir`` over 5 steps + one test batch (K5/K4): the Chrome trace
     names the flash attention kernel and K6b's dq and dk/dv kernels, the
     base weights unchanged; 9a, on ViT-B/16 through ``run()`` on a
     synthetic CS tree (``RUNNER_PEFT_OPTS`` + LoRA rank 8 with
     ``lora_mlp``, ``save_model``, ``checkpoint_interval 1``, 2 epochs):
     the base weights bit-identical, every adapter moved,
     ``lora_adapters.npz`` with JAX's keys, 12 K1 per eval batch;
     ``ClassifierEngine(lora=)`` against an engine on the returned W_eff
     (max|dprob| 0) and K1 plain on W_eff (``COS_MIN``), and its int8 twin
     (K8 + 12 K14); 9c, ``device_dataset`` False / True / 'chunked' (3
     chunks an epoch) bit for bit, the split's uploads counted; 9b, ``python
     -m aihab_clip_tpu_torch`` (3 epochs, the K1 prefix) sent SIGTERM after
     its first epoch, exit 0 with the epoch checkpoint, then resumed by a
     second CLI run: its final parameters against an uninterrupted run, bit
     for bit; A18b (a): the checkpoints are JAX's orbax layout
     (``state/manifest.ocdbt``, ``_METADATA``), and the final one is
     written again and read back bit for bit, its bytes and seconds beside
     ``torch.save``/``torch.load`` of the same payload; the uninterrupted
     run's K1 prefix launches go to K1's A10 count;
  10. weights path — the ViT-B/16 engine's weights as an OpenAI fp16
     state-dict ``.pt`` (after 8b), the SO400M engine's as an HF snapshot
     of BF16 safetensors in 2 shards with a stripped ``config.json`` and a
     byte-fallback BPE ``tokenizer.json``, read as
     ``hf-hub:timm/ViT-SO400M-16-SigLIP2-384`` through its alias under a
     temporary ``HF_HOME`` (after 9d/9e), the ConvNeXt base_w engine's as an
     open_clip ``open_clip_pytorch_model.bin`` in the snapshot
     ``laion/CLIP-convnext_base_w-laion2B-s13B-b82K`` (after 6d), each in
     a temporary directory deleted after: ``ClassifierEngine`` on each
     name, its probabilities equal bit for bit to an engine on the source
     weights rounded to the file's dtype, K1 / K5 + K4 / K7 launched; the
     ``.pt`` and ConvNeXt names again from the converted cache
     (``npz-cache``); the SigLIP text head on the snapshot's tokenizer ids;
     load seconds (host clock), file sizes and host RSS;
  A14. tools path — the offline tools on the card (no TPU kernel lies on
     them: JAX leaves them to scikit-learn and OpenCV): ``run_grid`` over
     ``sweeps/openclip_ft.yaml`` (2 combinations) and ``sweeps/lora_ft.yaml``
     (1) on the runner's tree with random:ViT-B/16 (the CSV rows printed,
     sorted by top1_acc, finite), ``run_ft_sweep`` as a subprocess (its
     overrides and run name); ``cs_clean_testset score`` single and multi
     on the PEFT run's test embedding cache and a synthetic 20,000 x 512
     one against the port's CPU run (similarities, ranks and flags but for
     ties, each class's k-means inertia from the card's initial centres),
     the planted rows' recall; ``feat_vis`` t-SNE of the 20,000 points
     (finite, the KL falling after exaggeration, the 10-NN label agreement
     at least the PCA init's) and a 600-row draw's P and KL against the
     CPU; ``canny_rgb`` and ``edge_blend`` on 64 x 224^2 photos and the
     12 MP one bit for bit with the CPU; the seconds and ms of each;
  7. one JSON line listing every kernel (with each kernel's A10 launches)
     and every phase's figures (A18's under ``jax_formats``); last line
     ``{"ok": true, ...}``.
Each phase prints its seconds.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
# the fast JPEG decode (ops/jpeg.py): J1 and J2 replace the JAX package's
# host libjpeg decode (native/image_pipeline.cpp decode_body; no TPU kernel)
SRC_JPEG = "aihab_clip_tpu_torch/csrc/jpeg_pixels.cu"
JAX_JPEG = "native/image_pipeline.cpp:58"
# J1's and J2's integer operations are held against the card's rate outside
# the tensor cores (H100 SXM fp32, 67 T/s); per block of IDCT size 8 / 4 /
# 2 / 1 and per output pixel of J2 (4 taps x 3 components, the colour
# transform, the weights), counted from the source
PEAK_CORE_OPS = 67e12
J1_OPS = {8: 800, 4: 260, 2: 80, 1: 4}
J2_OPS = 200
# J2's four-component instance: a fourth sample a tap, YCCK's YCbCr -> RGB
# and cv2's CMYK -> BGR
J2_CMYK_OPS = 280
# 8b: the HTTP serving phase on the bf16 ViT-B/16 engine: a 1024 x 768
# photo (h, w) beside the 12 MP one, SERVE_CLIENTS client threads,
# SERVE_ROUNDS rounds of one raw, one JSON (2 photos) and one binary (4
# photos) request each; INT8_SERVE requests through the int8 engine; the
# answers against classify_batch of the engine's own decode
SERVE_MID, SERVE_MIDS, SERVE_CLIENTS, SERVE_ROUNDS = (768, 1024), 4, 8, 16
INT8_SERVE, SERVE_PROB_TOL = 8, 1e-3
SERVE_DIM = 224   # ViT-B/16's decode_dim (serving.ClassifierEngine)
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
# the weights path: the ViT-B/16, SO400M and ConvNeXt base_w bundles written
# in their published layouts (an OpenAI fp16 state-dict .pt; an HF SigLIP
# snapshot of BF16 safetensors in WEIGHTS_SHARDS shards under the alias of
# configs/base.yaml's open_clip_model; an open_clip snapshot), then served
WEIGHTS_SHARDS = 2
SL_HUB = "hf-hub:timm/ViT-SO400M-16-SigLIP2-384"
SL_HF_REPO = "google/siglip2-so400m-patch16-384"
CX_HF_REPO = "laion/CLIP-convnext_base_w-laion2B-s13B-b82K"
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
# 8: the runner phase's tree (train and test photos per class, pixels), the
# --opts over configs/base.yaml + cs.yaml (cs.yaml's valid_split 0.01 asks
# for 100 folds, more than the tree's 60 survey plots: StratifiedGroupKFold
# refuses that in both packages), the PEFT run's opts, the (height, width)
# of the large synthetic JPEG timed whole and per megapixel, and the
# projector's limit
# against the CPU (both fp32: summation orders apart)
RUNNER_TREE = (8, 3, 64)
RUNNER_OPTS = ["data.preprocessing.resize", "256",
               "data.data_split.valid_split", "0.2",
               "clip_backend", "openai", "backbone", "random:ViT-B/16",
               "save_features", "True", "aug_views", "3", "search_lr", "True",
               "train_epoch", "5", "wandb_project", "None"]
RUNNER_PEFT_OPTS = ["clip_backend", "openclip",
                    "open_clip_model", "random:ViT-B/16", "train_epoch", "2",
                    "save_features", "False", "wandb_project", "'smoke'"]
RUNNER_LARGE_JPEG = (3000, 4000)   # a 12 MP survey photo, 4:3
RUNNER_TIMED = 40   # photos timed for the fast decode figures
LOADER_RSS_FILES = 64   # 12 MP JPEGs of the loader's peak RSS figure
LOADER_RSS_RESIZE = 439   # configs/cs.yaml's resize: the prescale's m = 4
RUNNER_PROJ_REL = 1e-4
# A18: the rows of the tiled ViT-B/16 feature cache the store's GB/s is
# read on (each of the runner's 3 views repeated to this many rows)
CACHE_ROWS = 20_000
# 9: A10 — the LoRA rank of the runner's and SO400M's LoRA runs, the chunks
# an epoch of the chunked regime, and the SO400M profiled finetune's train
# and test images (5 steps at batch 16, one test batch)
A10_LORA_RANK, A10_CHUNKS, A10_PROFILE_SPLITS = 8, 3, (80, 16)
# A11: the RN engines' top-1 agreement with the fp32 canonical tower over
# one batch of random images; the RN50 PEFT step's unlock depth (stage 4 +
# the attention pool); the RN50 runner's ProLIP epochs
RN_TOP1_MIN, RN_PEFT_UNLOCKED, RN_RUNNER_EPOCHS = 0.95, 2, 5
# the cosine the random RN towers' fp32 features (BatchNorm calibrated,
# tools/rn_gains.calibrate_bn_) must keep under 1e-3 N(0, 1) input noise
# for a bf16 encode's comparison with them to mean anything
RN_STABLE_MIN = 0.9999
# A14: the tools path.  The sweeps (file, combinations run) on the runner's
# tree with RUNNER_OPTS + RUNNER_PEFT_OPTS in a temporary base config; the
# synthetic embedding cache (rows, ViT-B/16's embedding width, classes), the
# sizes of its classes in heuristic_k's bands below 300 (< 20, 20-99,
# 100-199, 200-299; the rest share the remaining rows), its share of rows
# planted from other classes; the scorers' limits against the port's CPU
# run (similarity columns, the window inside which ranks and flags may
# differ, the k-means inertia from the same initial centres, relative) and
# the planted rows' least recall; the t-SNE draw held against the CPU, its P
# limit and final KL limit (relative); the Canny batch (photos, side)
TOOLS_SWEEPS = (("sweeps/openclip_ft.yaml", 2), ("sweeps/lora_ft.yaml", 1))
TOOLS_CACHE = (20000, 512, 20)
TOOLS_BANDS, TOOLS_PLANTED = (12, 60, 150, 250), 0.01
TOOLS_SIM_TOL, TOOLS_INERTIA_REL, TOOLS_RECALL = 1e-5, 1e-4, 0.95
TOOLS_TSNE_DRAW, TOOLS_P_TOL, TOOLS_KL_REL = 600, 1e-6, 0.02
TOOLS_CANNY = (64, 224)
# A17: the LAION towers' default fine-tune (batch 16 at 224 from 439x439,
# unlocked_groups 11 -> a frozen prefix of L + 1 - 11 blocks: 22 / 30 / 38,
# tune_text) at full width and depth, A17_WARM warm-up and A17_TIMED timed
# steps each with the K1 and the K14 prefix; scan_blocks + scan_remat on
# ViT-H/14 (D2 on a GELU tower); the OpenAI ViT-L/14 (S = 257) and
# ViT-L/14@336px (S = 577) rows: VITL_REQUESTS single requests through each
# engine (bf16 and int8), the feature cache over VITL_CACHE images in
# VITL_CACHE_VIEWS views, and the same PEFT step (prefix 14)
A17_TOWERS = ("ViT-H/14", "ViT-g/14", "ViT-bigG/14")
A17_WARM, A17_TIMED = 2, 3
VITL_ARCHS = ("ViT-L/14", "ViT-L/14@336px")
VITL_REQUESTS, VITL_CACHE, VITL_CACHE_VIEWS = 96, 32, 2
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
# A17's K14-prefix step against the same step with K14 plain, by tower: K14
# is held to its plain version at TOL "int8_block", not bit for bit, and a
# code that flips between the two (an fp32 sum in another order) moves its
# row by one int8 step, more so over more prefix blocks.  The loss limit is
# VIT_STEP_GATES["plain"]'s (the loss does not tell a flip from a skipped
# quantization); the cosine limit sits between the flips' reading and the
# control's, the unquantized K1-prefix step against K14 plain, which must
# fail it.  On an H100 (PERF.md) 1 - cosine read, flips against the K14
# step vs the K1 step: ViT-H/14 6.9e-5 vs 3.94e-4, ViT-g/14 6.6e-5 vs
# 4.42e-4, ViT-bigG/14 2.07e-4 vs 6.66e-4, ViT-L/14 9.5e-5 vs 3.38e-4,
# ViT-L/14@336px 4.0e-5 vs 5.69e-4; each limit is their geometric mean
INT8_PLAIN_COS = {"ViT-H/14": 0.99984, "ViT-g/14": 0.99983,
                  "ViT-bigG/14": 0.99963, "ViT-L/14": 0.99982,
                  "ViT-L/14@336px": 0.99985}
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

    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-worker":
        parallel_worker(sys.argv[2], sys.argv[3])
        return
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

    # ---- 2. build (one nvcc per CUDA source and the host compiler for
    # jpeg_entropy.cpp, all started together)
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.2f}s total")
    for name, info in _build.build_info.items():
        print(f"[build] {name}: built in {info['seconds']}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"[build] {line.strip()}")
    kernel_plans(_build)
    phase("build")

    # ---- A18 (c): the files JAX wrote, read by the codecs just built
    jax_fixtures = jax_fixtures_path(smi)
    phase("jax-written fixtures")
    big, mids, adobe = smoke_jpegs()

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

    # ---- 3i. the fast JPEG decode: C++ coefficients, J1 and J2
    jpeg_figures = jpeg_kernel_cases(timed, rows, big, mids, adobe)
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
    phase("vit fast path")

    # ---- 8b. serving over HTTP: PredictServer, its three wires, the decode
    counts["serving"], serving_figures = serving_path(engine, big, mids,
                                                      adobe, smi)
    phase("serving path")

    # ---- 10. the weights path: the engine's weights as an OpenAI .pt
    weights = {"vit_b16": weights_path("vit_b16", engine, bk, smi)}
    del engine
    torch.cuda.empty_cache()
    phase("weights path (ViT-B/16 .pt)")

    # ---- 5c. the int8 ViT-B/16 path: engine + dynamic batcher
    (counts["vit_int8"], counts["vit_int8_off"], rates["vit_b16_int8_64"],
     vit_int8_figures, engine) = vit_int8_path(bk, images, probs,
                                               rates["vit_b16_64"])
    phase("vit int8 path")

    # ---- 8c. a few HTTP requests through the int8 engine (K8 + K14)
    counts["serving_int8"] = serving_int8(engine, mids)
    phase("serving int8")

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
    int8_runs, rates["siglip_so400m_int8_64"], int8_figures = \
        siglip_int8_path(bk, engine, rates["siglip_so400m_64"])
    counts["siglip_int8"] = int8_runs.pop("split")
    counts.update(int8_runs)
    phase("siglip int8 path")

    # ---- 6. the SigLIP PEFT path on the engine's weights
    counts["siglip_peft"], train = peft_path(engine, bk)
    phase("peft path")

    # ---- 9d/9e. A10 on SO400M: the scanned, remat'd LoRA step; profile_dir
    a10_so = a10_so400m_path(engine, bk, smi)
    phase("a10 so400m path")

    # ---- 10. the weights path: SO400M as an HF snapshot (BF16 shards)
    weights["so400m"] = weights_path("so400m", engine, bk, smi)
    del engine
    torch.cuda.empty_cache()
    phase("weights path (SO400M HF snapshot)")

    # ---- 5d. the ConvNeXt base_w bf16 and int8 engines + dynamic batcher
    cx_counts, cx_rates, cx_figures, engine = convnext_path(bk)
    counts.update(cx_counts)
    rates.update(cx_rates)
    phase("convnext paths")

    # ---- 6d. the ConvNeXt base_w PEFT step and finetune on its weights
    cx_train = convnext_peft_path(engine.bundle.model, bk)
    phase("convnext peft path")

    # ---- 10. the weights path: ConvNeXt base_w as an open_clip snapshot
    weights["convnext_base_w"] = weights_path("convnext_base_w", engine, bk,
                                              smi)
    del engine
    torch.cuda.empty_cache()
    phase("weights path (ConvNeXt open_clip .bin)")

    # ---- 5f. the LAION ViT-H/14, ViT-g/14 and ViT-bigG/14 engines
    large_counts, large_rates, large_figures = large_vit_paths(bk)
    counts.update(large_counts)
    rates.update(large_rates)
    phase("large vit paths")

    # ---- A17. the LAION towers' fine-tune steps (K1 and K14 prefixes,
    # scan_blocks on ViT-H/14), the OpenAI ViT-L/14 and ViT-L/14@336px rows
    a17 = {"large": large_peft_paths(bk, smi)}
    phase("a17 large peft")
    vitl_counts, vitl_rates, a17["vitl"] = vitl_paths(bk, smi)
    counts.update(vitl_counts)
    rates.update(vitl_rates)
    phase("a17 vit-l paths")

    # ---- 8. the port's own entry point: the runner, ProLIP and PEFT
    runner = runner_path(bk, smi, big)
    phase("runner path")

    # ---- 9a-9c. A10 on ViT-B/16: LoRA through the runner and the engines,
    # resume after SIGTERM through the CLI, the epoch regimes
    a10_vit = a10_runner_path(bk, smi)
    phase("a10 runner path")

    # ---- A11. the ModifiedResNet towers: RN50 and RN50x64
    resnet = resnet_paths(bk, smi, mids)
    rates.update(rn50_64=resnet["rn50"]["images_per_s"],
                 rn50x64_16=resnet["rn50x64"]["images_per_s"])
    phase("resnet paths")

    # ---- A14. the tools: sweeps, outlier scoring, PCA + t-SNE, Canny
    tools = tools_path(smi)
    phase("tools path")

    # ---- A13. the parallel paths: one NCCL rank, then two ranks (DP, TP,
    # FSDP, the pipeline, the DP eval, the sharded cache; A13b: per-block
    # FSDP and TP at full width against their whole-gather controls)
    parallel = parallel_path(smi)
    phase("parallel paths")

    # ---- 7. kernels line + result
    names = {"vit": "ViT-B/16 engine + DynamicBatcher",
             "vit_off": "ViT-B/16 merge_blocks='off' encode",
             "vit_int8": "ViT-B/16 int8 engine + DynamicBatcher",
             "vit_int8_off": "ViT-B/16 int8 merge_blocks='off' encode",
             "siglip": "SigLIP SO400M engine + DynamicBatcher",
             "siglip_int8": "SigLIP SO400M int8 engine + DynamicBatcher",
             "siglip_int8_chained": "SigLIP SO400M int8 encode, JAX's "
                                    "chained route (batch 64)",
             "siglip_peft": f"SigLIP SO400M finetune ({PEFT_SPLITS[0] // PEFT_B}"
                            " steps + val/test)",
             "convnext": "ConvNeXt base_w engine + DynamicBatcher",
             "convnext_int8": "ConvNeXt base_w int8 engine + DynamicBatcher",
             "vit_fast": "ViT-B/16 uint8 -> normalize_u8 -> vit_encode_fast",
             "vit_train": f"ViT-B/16 vit_encode_train step (batch {TRAIN_B})",
             "serving": "PredictServer + ViT-B/16 engine, JPEG requests "
                        "over HTTP"}
    for arch, tag in LARGE_TAGS.items():
        names.update({tag: f"{arch} engine + DynamicBatcher",
                      tag + "_jax": f"{arch} JAX's route (K5 + K4) encode",
                      tag + "_int8": f"{arch} int8 engine + DynamicBatcher",
                      tag + "_int8_jax": f"{arch} JAX's int8 route (K13 + "
                                         "K9 -> K10) encode"})
    a10_l = a10_vit["launches"]
    so_run, so_step = a10_so["launches_finetune"], a10_so["launches_step"]
    # the A10 launches of each kernel at the row of the A10 paths' shapes
    # (ViT-B/16 bf16 and int8, SO400M)
    a10_counts = {
        "full_block_fused": a10_l["lora_run"]["full_block_fused"]
        + a10_l["lora_engine"]["full_block_fused"] + a10_l["regimes_k1"]
        + a10_l["resume_ref_k1"],
        "quant_full_block_fused":
            a10_l["lora_engine_int8"]["quant_full_block_fused"],
        "fused_attention_fwd": so_step["fused_attention_fwd"]
        + so_run["fused_attention_fwd"],
        "fused_attention_bwd": so_step["fused_attention_bwd"]
        + so_run["fused_attention_bwd"],
        "attn_block_split": so_run["attn_block_split"],
        "mlp_block_split": so_run["mlp_block_split"]}
    for row in rows:
        counter = row.pop("counter").__name__
        if row["name"] in a10_counts:
            row["a10_launches"] = a10_counts[row["name"]]
        row["launches"] = counts[row["path"]][counter]
        row["path"] = names[row["path"]]
        check(row["launches"] > 0, f"{row['name']} never launched on its path")
        if counter == "full_block_fused":
            row["runner_launches"] = (runner["prolip_k1_launches"]
                                      + runner["peft_k1_launches"]
                                      + runner["file_root"]["k1_launches"])
            # the DP step's K1 per rank (the parallel phase's subprocesses)
            row["parallel_launches"] = parallel["pair"]["k1_per_dp_rank"]
    print(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    print(json.dumps({"kernels": rows, "card": smi, "images_per_s": rates,
                      "int8": int8_figures, "vit_int8": vit_int8_figures,
                      "convnext": cx_figures, "train": train,
                      "vit_train": vit_train, "convnext_train": cx_train,
                      "vit_fast": fast_figures,
                      "vit_encode_train": fast_train, "int8_core": int8_core,
                      "large_vit": large_figures, "runner": runner,
                      "a10": {"vit_b16": a10_vit, "so400m": a10_so},
                      "jpeg": jpeg_figures, "serving": serving_figures,
                      "weights": weights, "resnet": resnet, "a17": a17,
                      "tools": tools, "parallel": parallel,
                      "jax_formats": {
                          "fixtures": jax_fixtures,
                          "resume": dict(a10_vit["jax_layout"],
                                         k1_launches=a10_l["resume_ref_k1"],
                                         bit_identical=a10_vit[
                                             "resume_bit_identical"]),
                          "file_root": runner["file_root"]}}))
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
    x 3, bit for bit (bf16, fp32, a ragged tail), its device time from a
    CUDA graph of launches and its host time a call
    (``tools/k18_time.measure``); each against its plain version."""
    import torch

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import fused_linear as fl
    from aihab_clip_tpu_torch.ops import pallas_preprocess as pp
    from aihab_clip_tpu_torch.tools import k18_time

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
    k18 = next(r for r in run_cases(cases) if r["name"] == "normalize_u8_pallas")
    # K18's own device time (a CUDA graph of launches: the host's ctypes call
    # outlasts the kernel, so back-to-back calls time the host), with the L2
    # evicted before each launch (its input and output fit the 50 MB L2
    # together, so repeated launches run from it) and warm, and the host time
    # per call; bf16 and fp32 and a ragged tail bit for bit
    fig = k18_time.measure(pp)
    check(fig["exact"], "K18 is not bit for bit its plain version (bf16, "
          "fp32, ragged)")
    # without a profiler reading there is no cold figure: the row then takes
    # the warm graph time and says so
    cold = fig["cold_ms"]
    where = "with the L2 evicted" if cold is not None else (
        "warm (torch.profiler gave no reading with the L2 evicted)")
    k18.update(ms=fig["graph_ms"] if cold is None else cold, ms_l2=where,
               warm_ms=fig["graph_ms"], events_ms=k18["ms"],
               host_ms=fig["host_ms"], fp32_warm_ms=fig["fp32_graph_ms"])
    print(f"[kernels] normalize_u8_pallas device time {k18['ms']:.4f} ms "
          f"{where} ({k18['bound_ms'] / k18['ms']:.0%} of the "
          f"{k18['bound_ms']:.4f} ms bound), {fig['graph_ms']:.4f} ms warm (a "
          f"graph of {fig['launches']}), fp32 out {fig['fp32_graph_ms']:.4f} "
          f"ms warm; host time {fig['host_ms']:.4f} ms a call, events over "
          f"calls back to back {k18['events_ms']:.4f} ms")
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
    wq8k, wo8k = qm.int8_weight(wq8), qm.int8_weight(wo8)
    bq = vec(3 * w)
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
        # K8's instances on JAX's chained route (A15b): the packed qkv with
        # the LN1 prologue, the out-projection with the residual
        ("quant_matmul_fused[SigLIP qkv, LN1]", f"{JAX_QM}:376", "kernel",
         lambda: qm.quant_matmul_fused(x2, wq8k, sq, bq, ln_scale=ln1[0],
                                       ln_bias=ln1[1], ln_eps=1e-6),
         lambda: qm.quant_matmul_fused_plain(x2, wq8k, sq, bq,
                                             ln_scale=ln1[0], ln_bias=ln1[1],
                                             ln_eps=1e-6),
         lambda: int_mm(mm_in[w], wq8k), (0, f_qkv),
         2 * m * w + 8 * w + 3 * w * w + 8 * 3 * w + 2 * m * 3 * w,
         qm.quant_matmul_fused, "siglip_int8_chained", SRC_Q),
        ("quant_matmul_fused[SigLIP out-proj, residual]", f"{JAX_QM}:376",
         "kernel",
         lambda: qm.quant_matmul_fused(x2, wo8k, so, bo, residual=x2),
         lambda: qm.quant_matmul_fused_plain(x2, wo8k, so, bo, residual=x2),
         lambda: int_mm(mm_in[w], wo8k), (0, f_out),
         2 * m * w + w * w + 8 * w + 2 * m * w + 2 * m * w,
         qm.quant_matmul_fused, "siglip_int8_chained", SRC_Q),
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
    head_dim 64 with fp32 output (beside SDPA at its shape), and the
    requantize of the attention row."""
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
    # SDPA's q, k, v at the normalised-P attention's shape (its yardstick)
    heads_of = [t.reshape(B, S, HEADS, d).transpose(1, 2)
                for t in qkv.split(W, -1)]
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
         lambda: torch.nn.functional.scaled_dot_product_attention(*heads_of),
         f_att, 2 * m * 3 * W + 4 * m * W, bk.attention, "vit_int8"),
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


def check_step(tag, name, got, ref, gate, *, control=False):
    """A train step's (loss, gradient) against a reference step's: loss
    relative |d| and gradient cosine within ``gate``; returns the figures.
    A ``control`` step must fall outside the gate."""
    import torch

    (loss_k, g_k), (loss_r, g_r) = got, ref
    rel = abs(loss_k - loss_r) / abs(loss_r)
    cos = torch.nn.functional.cosine_similarity(g_k, g_r, dim=0).item()
    lim_rel, lim_cos = gate
    print(f"[{tag}] train step{' (control)' if control else ''} vs {name}: "
          f"loss {loss_k:.6f} vs {loss_r:.6f}, rel |d| {rel:.3e} (limit "
          f"{lim_rel:g}); gradient cosine {cos:.6f} (limit {lim_cos:g}), |g| "
          f"{g_k.norm().item():.4g} vs {g_r.norm().item():.4g}")
    within = rel <= lim_rel and cos >= lim_cos
    if control:
        check(not within, f"{tag}: the control step passes the gate against "
              f"{name}")
    else:
        check(within, f"{tag} train step vs {name}")
    return dict(loss=loss_r, loss_rel=rel, grad_cos=cos)


def timed_steps(step, imgs, labs, valid, pp, epoch, reset=None, warm=2,
                timed=5):
    """CUDA-event ms of ``timed`` train steps after ``warm`` warm-up ones
    (``reset()`` just before the first timed one)."""
    import torch

    from aihab_clip_tpu_torch.train.peft import step_generator

    times = []
    for i in range(warm + timed):
        if i == warm and reset is not None:
            reset()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(imgs, labs, valid, step_generator(SEED, epoch, i), PEFT_LR, pp)
        e1.record()
        torch.cuda.synchronize()
        if i >= warm:
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
def same_weights(bundle):
    """Inside the block ``models.load`` returns ``bundle``, so an int8
    engine of the model a bf16 engine serves quantizes those weights (the
    same seeded draw) instead of drawing them again on the host."""
    from unittest import mock

    from aihab_clip_tpu_torch import models

    with mock.patch.object(models, "load", lambda *a, **k: bundle):
        yield bundle


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
    """ClassifierEngine(quantize="int8") + DynamicBatcher on the bf16
    engine's seeded SO400M weights (``same_weights``: the engine takes a
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
    with same_weights(bf16_engine.bundle):
        engine = ClassifierEngine(model=SL_MODEL, batch_size=64,
                                  quantize="int8", device="cuda")
    t_built = time.perf_counter() - t0
    engine.warmup()
    cfg = engine.bundle.config
    res, dim = cfg.image_resolution, engine.decode_dim
    qp = engine._qparams
    n_groups = int(qp["transformer"]["resblocks_0"]["attn/qkv_g"]["w8_g"]
                   .shape[0])
    print(f"[int8] {SL_MODEL} quantize='int8': built in {t_built:.1f}s (a "
          f"bf16 engine's seeded weights), warm in "
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
    figures["routes"], routes_run = siglip_int8_routes(
        bk, engine, bf16_engine, batch, xb)
    del engine, model, batch, xb, ref_tower
    torch.cuda.empty_cache()
    return {"split": run, **routes_run}, rate, figures


def siglip_int8_routes(bk, engine, bf16_engine, batch, xb):
    """JAX's other two int8 routes of ``siglip_encode_int8`` at batch 64
    (A15b): ``attn_impl="chained"`` (K8 with the LN1 prologue, K6f, K8 with
    the residual, K9 -> K10; the patch embed through K8) and ``impl="xla"``
    (``quant_dense`` through ``torch._int_mm``, K6f for the core), each
    counted from zero over one encode, held against the bf16 engine's
    features (``INT8_COS["fp32"]``) and the split route's top-1; device ms
    (CUDA events) and images/s of the encode.  Returns (figures, {route:
    launches})."""
    import torch

    from aihab_clip_tpu_torch.models import quant_siglip as qs
    from aihab_clip_tpu_torch.models.fast_vit import encode_image_fastest
    from aihab_clip_tpu_torch.ops import attention as att
    from aihab_clip_tpu_torch.ops import quant_matmul as qm

    qp, model, cfg = engine._qparams, engine.bundle.model, engine.bundle.config
    n, layers = xb.shape[0], cfg.vision_layers

    def probs(feats):
        f = torch.nn.functional.normalize(feats.float(), dim=-1)
        return torch.softmax(100.0 * f @ engine._text_weights, -1)

    def encode(**kw):
        return qs.siglip_encode_int8(qp, model, xb, cfg, **kw)

    with torch.inference_mode():
        bf16 = encode_image_fastest(bf16_engine.bundle.model, xb, cfg,
                                    project=True,
                                    packed=bf16_engine._packed)[1].float()
        split_top1 = probs(encode()).argmax(-1)
    figures, launches = {}, {}
    want = {
        "chained": {"quant_matmul_fused": 1 + 2 * layers,
                    "quant_matmul_fused_qout": layers,
                    "quant_matmul_q8in": layers,
                    "quant_attn_block_split": 0,
                    "fused_attention_fwd": layers,
                    "row_quant": 1 + 3 * layers, "int8_gemm": 1 + 4 * layers},
        "xla": {"quant_matmul_fused": 0, "quant_matmul_fused_qout": 0,
                "quant_matmul_q8in": 0, "quant_attn_block_split": 0,
                "fused_attention_fwd": layers, "row_quant": 0,
                "int8_gemm": 0}}
    for route, kw in (("chained", dict(attn_impl="chained")),
                      ("xla", dict(impl="xla"))):
        with torch.inference_mode():
            for reset in (bk.reset_launch_counts, qm.reset_launch_counts,
                          att.reset_launch_counts):
                reset()
            feats = encode(**kw).float()
            torch.cuda.synchronize()
            got = {**bk.launch_counts(), **qm.launch_counts(),
                   **att.launch_counts()}
            launches[f"siglip_int8_{route}"] = got
            cos = torch.nn.functional.cosine_similarity(feats, bf16, dim=-1)
            top1 = (probs(feats).argmax(-1) == split_top1).float().mean()
            ms = staged_ms(xb, [("encode", lambda x: encode(**kw))], 3)[0][
                "encode"]
        for key, v in want[route].items():
            check(got[key] == v, f"int8 {route}: {key} launched {got[key]} "
                  f"times in one encode (want {v})")
        check(bool(torch.isfinite(feats).all()) and feats.shape == bf16.shape,
              f"int8 {route}: features {tuple(feats.shape)}")
        check(cos.min().item() >= INT8_COS["fp32"],
              f"int8 {route}: cosine vs the bf16 engine {cos.min().item()}")
        figures[route] = dict(cos_bf16_min=cos.min().item(),
                              cos_bf16_mean=cos.mean().item(),
                              top1_vs_split=top1.item(), encode_ms=ms,
                              images_per_s=1e3 * n / ms)
        print(f"[int8] route {route} at batch {n}: launches "
              f"{ {k: got[k] for k in want[route]} }; features vs the bf16 "
              f"engine cosine min {cos.min().item():.6f} mean "
              f"{cos.mean().item():.6f} (limit {INT8_COS['fp32']}); top-1 "
              f"agreement with the split route {top1.item():.4f}; encode "
              f"{ms:.3f} ms (device), {1e3 * n / ms:.1f} images/s")
    return figures, launches


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
    im2col (K = 588, padded to 592), bit for bit; the int8 GEMMs each beside
    ``torch._int_mm`` at its shape (int32 out; K8's with K padded to
    592)."""
    import torch

    from aihab_clip_tpu_torch.models.clip import CLIP_ARCHS
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.quant import quantize_weight

    f32 = torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    int_mm = torch._int_mm

    def weight(k, n):
        w8, ws = quantize_weight(rnd(k, n, scale=k ** -0.5, dtype=f32))
        return qm.int8_weight(w8), ws

    def codes(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             device="cuda")

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
        # torch._int_mm yardsticks (int32 out) at the int8 GEMMs' shapes, B
        # K-major as the kernels read it (cuBLASLt's fast layout), the patch
        # GEMM's K padded to 592
        h8_lib, w2_lib = codes(m, hid // ich), w28[sl].t().contiguous().t()
        p8_lib, wp_lib = codes(B * 256, 592), codes(w, 592).t()
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
             lambda: int_mm(l8, w18), (0, f_mlp // 2),
             m * w + 4 * m + w * hid + 8 * hid
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
             lambda: int_mm(l8, w18[:, sl]), (0, f_mlp // 2 // ich),
             2 * m * w + w * hid // ich + 8 * (w + hid // ich)
             + m * hid // ich + 4 * m, qm.quant_matmul_fused_qout,
             tag + "_int8_jax", SRC_Q),
            (f"quant_matmul_q8in[{arch} c_proj, 1 of {ich} slices]",
             f"{JAX_QM}:165", "kernel",
             lambda: qm.quant_matmul_q8in(*k10),
             lambda: qm.quant_matmul_q8in_plain(*k10),
             lambda: int_mm(h8_lib, w2_lib), (0, f_mlp // 2 // ich),
             m * hid // ich + 4 * m + hid // ich * w + 8 * w + 4 * m * w,
             qm.quant_matmul_q8in, tag + "_int8_jax", SRC_Q),
            (f"quant_matmul_fused[{arch} patch 14, K 588 in 592]",
             f"{JAX_QM}:376", "exact",
             lambda: qm.quant_matmul_fused(patches, wp8, sp, bp),
             lambda: qm.quant_matmul_fused_plain(patches, wp8, sp, bp),
             lambda: int_mm(p8_lib, wp_lib), (0, 2 * B * 256 * kp * w),
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
        del c_fc, h8_lib, w2_lib, p8_lib, wp_lib
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
            run, n, opt_probs = serve(eng, tag)
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
            # A15: the int8 engine under the opt-out takes JAX's XLA route
            # (quant_dense per GEMM, exact gelu, the plain attention): no
            # kernel launch; its features against the bf16 exact-gelu
            # engine's
            tag8 = f"{arch} int8 under AIHAB_NO_GELU_POLY=1 (the xla route)"
            eng8, fig["optout_int8_load_s"] = build(f"random:{arch}",
                                                    quantize="int8")
            run8, _, probs8 = serve(eng8, tag8)
            check(not any(run8.values()), f"{tag8}: launches {run8}")
            with torch.inference_mode():
                f8 = qv.vit_encode_int8(eng8._qparams, xb, cfg,
                                        project=True)[1].float()
            fig["optout_int8_cos_min"] = gate(
                tag8, "the bf16 exact-gelu engine", f8, g_k,
                INT8_COS["plain"])
            rate8 = images_per_s(eng8, B, 224)
            fig.update(optout_int8_launches=run8, optout_int8_images_per_s=rate8,
                       optout_int8_top1_vs_bf16=float(
                           (probs8.argmax(-1) == opt_probs.argmax(-1)).mean()))
            print(f"[large] {tag8}: classify_batch at batch {B}: {rate8:.1f} "
                  f"images/s (the bf16 exact-gelu engine {rate:.1f}); top-1 "
                  f"agreement {fig['optout_int8_top1_vs_bf16']:.4f}")
            del eng8, f8
        fig.update(optout_dprob=dprob, optout_top1=agree,
                   optout_images_per_s=rate)
        return run, rate

    def build(name, bundle=None, **kw):
        """The engine and the seconds its ``load`` took (the random weights
        are drawn on the host; ``bundle``: a bf16 engine's weights, reused,
        0 s)."""
        seconds = []
        real = models.load if bundle is None else (lambda *a, **k: bundle)

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
              + (" (random weights drawn on the host)" if bundle is None
                 else " (the bf16 engine's weights)")
              + f", engine built + warm in {time.perf_counter() - t0:.1f}s")
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
        bundle = eng.bundle
        del eng, packed, feats, xb
        torch.cuda.empty_cache()
        if arch == "ViT-H/14":
            continue

        # ---- int8, by the table's name, on the bf16 engine's weights
        eng, fig["int8_load_s"] = build(f"random:{arch}", bundle,
                                        quantize="int8")
        del bundle
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


# ---------------------------------------------------------------------------
# A17: the LAION towers' PEFT, scan_blocks on a GELU tower, the ViT-L rows
# ---------------------------------------------------------------------------


def _bit_sums(params) -> dict:
    """{name: (sum of the tensor's 32-bit words, sum of them weighted by
    their position mod 9973)}: any change of a value changes them."""
    import torch

    out = {}
    for name, p in params:
        words = p.detach().contiguous().view(torch.int32).flatten().long()
        pos = torch.arange(words.numel(), device=words.device) % 9973
        out[name] = (int(words.sum()), int((words * pos).sum()))
    return out


def reckon_peft_gib(config, unlocked: int) -> dict:
    """The fine-tune's device memory reckoned from the configuration alone
    (a model on the meta device): the fp32 parameters, the trainable
    leaves' fp32 gradients and Adam's two moments, the bf16 prefix pack."""
    import torch

    from aihab_clip_tpu_torch.models import CLIPModel
    from aihab_clip_tpu_torch.train.peft import build_lock_mask

    with torch.device("meta"):
        model = CLIPModel(config)
    mask = build_lock_mask(model, config.vision_layers,
                           config.transformer_layers, unlocked_groups=unlocked,
                           tune_text=True, unlocked_text_layers=1)
    named = dict(model.named_parameters())
    total = sum(p.numel() for p in named.values())
    train = sum(p.numel() for n, p in named.items() if mask[n])
    prefix_blocks = config.vision_layers + 1 - unlocked
    per_block = sum(p.numel() for p in
                    model.visual.transformer.resblocks[0].parameters())
    gib = {"params_fp32": 4 * total / 2 ** 30,
           "grads_adam_fp32": 12 * train / 2 ** 30,
           "prefix_bf16": 2 * per_block * prefix_blocks / 2 ** 30}
    gib["total"] = sum(gib.values())
    gib["params"], gib["trainable"] = total, train
    return gib


def reckon_gather_gib(config, tp: bool = False, text: bool = True) -> dict:
    """What reading the weights as they are cut should save a rank against
    gathering every weight whole, reckoned from the configuration alone (a
    model on the meta device), in GiB of fp32: FSDP (``tp`` False), every
    tower block's weights less the largest block's (a block gathers its
    own as it runs; the control holds every block whole beside its
    shards); TP, every weight the rules cut on the model axis (the shards
    are read in place; the control gathers them whole).  ``text`` False:
    a step that does not read the text tower (no ``tune_text``), which
    both sides leave as its shards."""
    import torch

    from aihab_clip_tpu_torch.models import CLIPModel, SigLIPModel
    from aihab_clip_tpu_torch.models.layers import GatherBlock
    from aihab_clip_tpu_torch.parallel.tensor import tp_local

    with torch.device("meta"):
        model = (CLIPModel(config) if hasattr(config, "transformer_width")
                 else SigLIPModel(config))
    if tp:
        cut = sum(p.numel() for n, p in model.named_parameters()
                  if tp_local(n))
        return {"tp_cut": 4 * cut / 2 ** 30}
    blocks = [sum(p.numel() for p in m.parameters())
              for n, m in model.named_modules() if isinstance(m, GatherBlock)
              and (text or not n.startswith("text."))]
    return {"blocks": 4 * sum(blocks) / 2 ** 30,
            "largest_block": 4 * max(blocks) / 2 ** 30,
            "drop": 4 * (sum(blocks) - max(blocks)) / 2 ** 30}


def large_peft_step(tag, model, bk, smi, *, scan=False) -> dict:
    """A17's fine-tune checks on one CLIP tower at full width and depth (the
    default fine-tune: batch 16 at the tower's resolution from 439x439
    uint8, random crop + rotation, tune_text, unlocked_groups 11, bf16 over
    fp32 Adam): one step with the K1 prefix against the same step with K1
    plain and against the fp32 tower (``VIT_STEP_GATES``); one with the K14
    prefix against K14 plain (``INT8_PLAIN_COS``, which the K1-prefix step
    must fail) and the K1-prefix step (``INT8_STEP_GATE``); launches per
    step; with ``scan``,
    ``scan_blocks`` + ``scan_remat`` (no prefix) against the unscanned step;
    then ``A17_WARM`` + ``A17_TIMED`` train steps of each (CUDA events) with
    their peak memory, frozen leaves bit for bit unchanged and trainable
    ones moved.  Trains ``model`` in place; returns the figures."""
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.models import build_text_head, fast_vit
    from aihab_clip_tpu_torch.models import quant_vit as qv
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _pack_prefix, _quantize_prefix, build_lock_mask,
        make_train_step, peft_fused_prefix_len)

    dev = torch.device("cuda")
    mcfg = model.config
    layers = mcfg.vision_layers

    def counts():
        return {**bk.launch_counts(), **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        qm.reset_launch_counts()

    n_prefix = peft_fused_prefix_len(mcfg, PEFT_UNLOCKED, dev)
    check(n_prefix == layers + 1 - PEFT_UNLOCKED, f"{tag} prefix {n_prefix}")
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
    frozen = [(n, p) for n, p in model.named_parameters() if not mask[n]]
    rng = np.random.default_rng(SEED + 17)
    imgs = torch.from_numpy(rng.integers(
        0, 256, (PEFT_B, PEFT_DECODE, PEFT_DECODE, 3), dtype=np.uint8)).to(dev)
    labs = torch.from_numpy(rng.integers(0, 20, PEFT_B)).to(dev)
    valid = torch.ones(PEFT_B, dtype=torch.bool, device=dev)
    step_grads = step_grads_fn(model, trainable, tokens, imgs, labs, valid)
    fig = dict(prefix=n_prefix, trainable_params=sum(
        p.numel() for _, p in trainable))
    print(f"[a17] {tag}: {len(trainable)} trainable leaves "
          f"({fig['trainable_params']:,} parameters), fused prefix {n_prefix}"
          f" of {layers} blocks, S = {(mcfg.image_resolution // mcfg.vision_patch_size) ** 2 + 1}")

    cfg_p = dataclasses.replace(cfg, fused_prefix=n_prefix)
    pprefix = _pack_prefix(model, cfg_p)
    reset()
    kern = step_grads(cfg_p, pprefix)
    per_step = counts()
    check(per_step["full_block_fused"] == n_prefix
          and per_step["quant_full_block_fused"] == 0,
          f"{tag}: K1 launches per step {per_step}")
    with mock.patch.object(fast_vit, "full_block_fused",
                           bk.full_block_fused_plain):
        reset()
        plain = step_grads(cfg_p, pprefix)
        check(not any(counts().values()), f"{tag} plain step launched")
    vis_dt, txt_dt = model.visual.dtype, model.text.dtype
    model.visual.dtype = model.text.dtype = torch.float32
    try:
        fp32 = step_grads(dataclasses.replace(
            cfg, compute_dtype=torch.float32, fused_prefix=0), None)
    finally:
        model.visual.dtype, model.text.dtype = vis_dt, txt_dt
    gates = {name: check_step(f"a17 {tag}", name, kern, ref,
                              VIT_STEP_GATES[name])
             for name, ref in (("plain", plain), ("fp32", fp32))}
    del plain, fp32

    cfg8 = dataclasses.replace(cfg_p, prefix_quant=True)
    qprefix = _quantize_prefix(model, cfg8)
    reset()
    int8 = step_grads(cfg8, qprefix)
    per_step_q = counts()
    check(per_step_q["quant_full_block_fused"] == n_prefix
          and per_step_q["full_block_fused"] == 0,
          f"{tag}: K14 launches per step {per_step_q}")
    with mock.patch.object(qv, "quant_full_block_fused",
                           qm.quant_full_block_fused_plain):
        reset()
        int8_plain = step_grads(cfg8, qprefix)
        check(not any(counts().values()), f"{tag} K14-plain step launched")
    gate8 = (VIT_STEP_GATES["plain"][0], INT8_PLAIN_COS[tag])
    gates["int8_plain"] = check_step(f"a17 {tag} int8", "K14 plain", int8,
                                     int8_plain, gate8)
    gates["int8_plain_control"] = check_step(
        f"a17 {tag} K1 prefix", "K14 plain", kern, int8_plain, gate8,
        control=True)
    gates["int8_prefix"] = check_step(f"a17 {tag} int8", "the K1-prefix step",
                                      int8, kern, INT8_STEP_GATE)
    del int8, int8_plain
    runs = [("k1_prefix", cfg_p, pprefix), ("k14_prefix", cfg8, qprefix)]
    if scan:
        cfg_s = dataclasses.replace(cfg, fused_prefix=0, scan_blocks=True,
                                    scan_remat=True)
        cfg_u = dataclasses.replace(cfg, fused_prefix=0)
        reset()
        scanned = step_grads(cfg_s, None)
        unscanned = step_grads(cfg_u, None)
        check(not any(counts().values()), f"{tag}: the scanned and "
              "unscanned steps launched a prefix kernel")
        gates["scan"] = check_step(f"a17 {tag} scan_blocks", "the unscanned "
                                   "step", scanned, unscanned,
                                   VIT_STEP_GATES["plain"])
        del scanned, unscanned
        runs.append(("scan_remat", cfg_s, None))
    del kern
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    frozen_before = _bit_sums(frozen)
    train_before = _bit_sums(trainable)
    fig["launches_per_step"] = {"k1_prefix": per_step["full_block_fused"],
                                "k14_prefix":
                                    per_step_q["quant_full_block_fused"]}
    for label, c, pp in runs:
        torch.cuda.reset_peak_memory_stats()
        _, step = make_train_step(model, c, None, tokens)
        times = timed_steps(step, imgs, labs, valid, pp, 1, warm=A17_WARM,
                            timed=A17_TIMED)
        del step
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fig[label] = dict(step_ms=statistics.median(times), step_ms_all=times,
                          peak_gib=peak)
        print(f"[a17] {tag} {label} train step at batch {PEFT_B}: median "
              f"{fig[label]['step_ms']:.3f} ms over {A17_TIMED} steps after "
              f"{A17_WARM} ({', '.join(f'{t:.2f}' for t in times)}); peak "
              f"{peak:.2f} GiB ({smi})")
        torch.cuda.empty_cache()
    changed = [n for n, v in _bit_sums(frozen).items()
               if v != frozen_before[n]]
    moved = [n for n, v in _bit_sums(trainable).items()
             if v != train_before[n]]
    check(not changed, f"{tag}: frozen leaves changed: {changed[:5]}")
    check(len(moved) > 0, f"{tag}: no trainable leaf moved")
    print(f"[a17] {tag}: {len(frozen)} frozen leaves bit for bit unchanged, "
          f"{len(moved)} of {len(trainable)} trainable leaves moved")
    fig["step_checks"] = gates
    del pprefix, qprefix
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return fig


def large_peft_paths(bk, smi: str) -> dict:
    """A17.  ``finetune``'s train step on ViT-H/14, ViT-g/14 and ViT-bigG/14
    at full width and depth (random weights from seed 0), each with the K1
    and the K14 prefix (``large_peft_step``), the memory reckoned from the
    configuration before the tower is built beside the measured peak;
    ``scan_blocks`` on ViT-H/14.  Returns the figures by tower."""
    import torch

    from aihab_clip_tpu_torch.models import CLIP_ARCHS, load

    figures = {}
    for arch in A17_TOWERS:
        tag = LARGE_TAGS[arch]
        gib = reckon_peft_gib(CLIP_ARCHS[arch], PEFT_UNLOCKED)
        print(f"[a17] {arch} reckoned before the build: {gib['params']:,} "
              f"parameters ({gib['params_fp32']:.2f} GiB fp32), "
              f"{gib['trainable']:,} trainable (gradients + Adam "
              f"{gib['grads_adam_fp32']:.2f} GiB), bf16 prefix "
              f"{gib['prefix_bf16']:.2f} GiB: {gib['total']:.2f} GiB before "
              "activations")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = load(f"random:{arch}", dtype=torch.bfloat16, device="cuda",
                     seed=SEED).model
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        figures[tag] = large_peft_step(arch, model, bk, smi,
                                       scan=arch == "ViT-H/14")
        figures[tag].update(reckoned_gib=gib, load_s=load_s)
        del model
        torch.cuda.empty_cache()
    return figures


def vitl_paths(bk, smi: str) -> dict:
    """A17's OpenAI rows, ViT-L/14 (224 px, S = 257) and ViT-L/14@336px
    (336 px, S = 577), random weights from seed 0: the bf16 engine (24 K1 a
    batch) and the int8 engine (K8 + 24 K14 a batch), each answering
    ``VITL_REQUESTS`` single requests through ``DynamicBatcher``, features
    against K1 plain (``COS_MIN``; int8: ``INT8_COS["fp32"]``, and the
    all-plain int8 encode at ``INT8_COS["plain"]``), images/s; the feature
    cache (``cache_features_from_loader``, ``VITL_CACHE_VIEWS`` views of
    ``VITL_CACHE`` images, K1 per block) read back; the PEFT step of
    ``large_peft_step`` on the bf16 engine's weights.  Returns (launch
    counts by path, images/s, figures)."""
    import tempfile
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.cache import (cache_features_from_loader,
                                            feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.config import ConfigNode
    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.models import quant_vit as qv
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.ops.preprocess import eval_transform
    from aihab_clip_tpu_torch.serving import ClassifierEngine, DynamicBatcher

    dev = torch.device("cuda")
    cos = torch.nn.functional.cosine_similarity
    counts, rates, figures = {}, {}, {}

    def launches():
        return {**bk.launch_counts(), **qm.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        qm.reset_launch_counts()

    def serve(eng, images, tag):
        reset()
        batcher = DynamicBatcher(eng, max_wait_ms=5.0)
        batcher.start()
        t0 = time.perf_counter()
        futures = [batcher.submit(img) for img in images]
        probs = np.stack([f.result(timeout=900) for f in futures])
        wall = time.perf_counter() - t0
        batcher.stop()
        run, n = launches(), batcher.stats.batches
        print(f"[vitl] {tag}: {len(futures)} requests in {wall:.3f}s over {n}"
              f" batches; launches {run}")
        check(probs.shape == (len(images), 20)
              and bool(np.isfinite(probs).all())
              and bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)),
              f"{tag} probabilities")
        return run, n, probs

    def gate(tag, name, feats, ref, limit):
        c = cos(feats.float(), ref.float(), dim=-1)
        print(f"[vitl] {tag} features vs {name}: cosine min "
              f"{c.min().item():.6f} mean {c.mean().item():.6f} (limit "
              f"{limit})")
        check(c.min().item() >= limit, f"{tag} cosine vs {name}")
        return c.min().item()

    for arch in VITL_ARCHS:
        tag = "vitl14" if arch == "ViT-L/14" else "vitl14_336"
        fig = figures[tag] = {}
        eng = ClassifierEngine(model=f"random:{arch}", batch_size=B,
                               device="cuda", verbose=False)
        eng.warmup()
        cfg, packed, res = eng.bundle.config, eng._packed, eng.resolution
        layers = cfg.vision_layers
        images = np.random.default_rng(SEED + 19).integers(
            0, 256, (VITL_REQUESTS, res, res, 3), dtype=np.uint8)
        batch = torch.from_numpy(images[:B]).to(dev)
        run, n, probs = serve(eng, images, f"{arch} bf16")
        counts[tag] = run
        check(run["full_block_fused"] == layers * n,
              f"{arch}: K1 launched {run['full_block_fused']} times for {n} "
              f"batches (want {layers} each)")
        with torch.inference_mode():
            xb = eval_transform(batch, res, dtype=torch.bfloat16)
            feats = fast_vit.vit_encode_block_fused(packed, xb, cfg,
                                                    project=True)[1]
            with mock.patch.object(fast_vit, "full_block_fused",
                                   bk.full_block_fused_plain):
                k1_plain = fast_vit.vit_encode_block_fused(
                    packed, xb, cfg, project=True)[1]
        fig["cos_k1_plain_min"] = gate(f"{arch} bf16", "K1 plain", feats,
                                       k1_plain, COS_MIN)
        rates[f"{tag}_64"] = images_per_s(eng, B, res)
        print(f"[vitl] {arch} bf16 classify_batch at batch {B}: "
              f"{rates[f'{tag}_64']:.1f} images/s ({smi})")

        # the feature cache, K1 per block, on the engine's weights and pack
        tmp = tempfile.mkdtemp(prefix="aihab_vitl_")
        try:
            ccfg = ConfigNode({
                "root_path": tmp, "dataset": "smoke", "seed": 1, "shots": 0,
                "clip_backend": "openai", "backbone": f"random:{arch}",
                "aug_views": VITL_CACHE_VIEWS,
                "data": {"preprocessing": {"augmentations": {
                    "random_crop": True, "rotation": True}}}})
            ds = synthetic_dataset(np.random.default_rng(SEED + 20),
                                   VITL_CACHE, PEFT_DECODE)
            view = SplitView(ds, np.arange(VITL_CACHE), PEFT_B)
            reset()
            t0 = time.perf_counter()
            cache_features_from_loader(ccfg, eng.bundle.model, view, res,
                                       {"train_size": VITL_CACHE},
                                       packed=packed)
            torch.cuda.synchronize()
            cache_s = time.perf_counter() - t0
            views, labels = read_preprojection_cache(feature_cache_dir(ccfg),
                                                     VITL_CACHE_VIEWS)
            k1 = launches()["full_block_fused"]
            want = layers * VITL_CACHE_VIEWS * len(view)
            check(k1 == want, f"{arch} cache: K1 launched {k1} (want {want})")
            check(all(v.shape == (VITL_CACHE, cfg.vision_width)
                      and v.dtype == np.float16
                      and np.isfinite(v.astype(np.float32)).all()
                      for v in views) and len(labels) == VITL_CACHE
                  and not np.array_equal(views[0], views[1]),
                  f"{arch} feature cache")
            fig["cache_images_per_s"] = VITL_CACHE * VITL_CACHE_VIEWS / cache_s
            print(f"[vitl] {arch} feature cache: {VITL_CACHE_VIEWS} views of "
                  f"{VITL_CACHE} images, {views[0].shape[1]} wide, {k1} K1 "
                  f"launches, {fig['cache_images_per_s']:.1f} images/s incl. "
                  "the write")
        finally:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)

        # the int8 engine (a second draw of the same seeded weights)
        eng8 = ClassifierEngine(model=f"random:{arch}", batch_size=B,
                                device="cuda", verbose=False, quantize="int8")
        eng8.warmup()
        qp = eng8._qparams
        run8, n8, probs8 = serve(eng8, images, f"{arch} int8")
        counts[tag + "_int8"] = run8
        check(run8["quant_matmul_fused"] == n8
              and run8["quant_full_block_fused"] == layers * n8
              and run8["full_block_fused"] == 0,
              f"{arch} int8 launches {run8}")
        with torch.inference_mode():
            feats8 = qv.vit_encode_int8(qp, xb, cfg, project=True)[1]
            with plain_int8_kernels():
                plain8 = qv.vit_encode_int8(qp, xb, cfg, project=True)[1]
        fig["int8_cos_plain_min"] = gate(f"{arch} int8", "all-plain kernels",
                                         feats8, plain8, INT8_COS["plain"])
        fig["int8_cos_k1_plain_min"] = gate(f"{arch} int8", "K1 plain",
                                            feats8, k1_plain,
                                            INT8_COS["fp32"])
        fig["int8_top1_vs_bf16"] = float((probs8.argmax(-1)
                                          == probs.argmax(-1)).mean())
        rates[f"{tag}_int8_64"] = images_per_s(eng8, B, res)
        print(f"[vitl] {arch} int8 classify_batch at batch {B}: "
              f"{rates[f'{tag}_int8_64']:.1f} images/s (bf16 "
              f"{rates[f'{tag}_64']:.1f}); top-1 agreement with bf16 "
              f"{fig['int8_top1_vs_bf16']:.4f} ({smi})")
        del eng8, qp, feats8, plain8, xb, feats, k1_plain, batch
        torch.cuda.empty_cache()

        # the PEFT step on the bf16 engine's weights
        fig["peft"] = large_peft_step(arch, eng.bundle.model, bk, smi)
        del eng, packed
        torch.cuda.empty_cache()
    return counts, rates, figures


# ---------------------------------------------------------------------------
# 8. the port's own entry point: config -> CS data -> cache -> ProLIP / PEFT
# ---------------------------------------------------------------------------


def smoke_photo(h: int, w: int, seed: int) -> np.ndarray:
    """A seeded RGB photo: 16 px patches of colour plus noise
    (``tools/decode_time.photo``, which times the 12 MP one)."""
    from aihab_clip_tpu_torch.tools.decode_time import photo

    return photo(h, w, seed)


def smoke_jpegs():
    """The 12 MP JPEG (RUNNER_LARGE_JPEG) and SERVE_MIDS 1024 x 768 ones,
    written by the port's encoder (4:2:0, quality 95, as cv2.imwrite), and
    two 1024 x 768 Adobe ones by tools/jpeg_fixtures.py: CMYK (4:4:4) and
    YCCK (2x2 on Y and K)."""
    from aihab_clip_tpu_torch.data.encode import encode_jpeg
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import (adobe_planes,
                                                          encode_adobe)

    t0 = time.perf_counter()
    big = encode_jpeg(smoke_photo(*RUNNER_LARGE_JPEG, SEED))
    mids = [encode_jpeg(smoke_photo(*SERVE_MID, SEED + 1 + i))
            for i in range(SERVE_MIDS)]
    adobe = [encode_adobe(adobe_planes(*SERVE_MID, SEED + 20), 0),
             encode_adobe(adobe_planes(*SERVE_MID, SEED + 21), 2, 90, (2, 2))]
    print(f"[jpeg] wrote a {RUNNER_LARGE_JPEG[1]}x{RUNNER_LARGE_JPEG[0]} "
          f"JPEG ({len(big)} bytes), {SERVE_MIDS} {SERVE_MID[1]}x"
          f"{SERVE_MID[0]} ones and a CMYK and a YCCK one in "
          f"{time.perf_counter() - t0:.1f}s")
    return big, mids, adobe


def progressive_case(big: bytes, coefs, dev) -> dict:
    """3i, progressive: the 12 MP photo re-coded as a progressive JPEG by
    tools/jpeg_fixtures.py (libjpeg's default script, optimal tables): the
    C++ decoder's coefficients of it equal the baseline file's bit for bit
    (``coefs``), and the card decode of it equals the baseline's at m = 8
    and m = 2; the host Huffman ms of both (``tools/decode_time``).
    Returns the figures."""
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.tools.decode_time import entropy_ms
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import progressive_recode

    figures = {}
    t0 = time.perf_counter()
    prog = progressive_recode(big, coefs)
    figures["progressive_recode_s_12mp"] = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(J.coefficients(prog),
                                                    coefs))
    print(f"[jpeg] 12 MP progressive re-code ({len(prog)} bytes, 10 scans) "
          f"in {figures['progressive_recode_s_12mp']:.1f}s; its C++ "
          f"coefficients equal the baseline file's: {same}")
    check(same, "the progressive 12 MP photo's coefficients differ")
    for m, pm in ((8, 0), (2, 2 * SERVE_DIM)):
        a, b = J.decode_blobs([big, prog], SERVE_DIM, "native", pm, dev)
        equal = a is not None and b is not None and np.array_equal(a, b)
        print(f"[jpeg] 12 MP progressive card decode at m = {m} equals the "
              f"baseline's: {equal}")
        check(equal, f"the progressive card decode differs at m = {m}")
    base_ms, prog_ms = entropy_ms(big, 3), entropy_ms(prog, 3)
    figures["huffman_ms_12mp"] = {"baseline": base_ms, "progressive": prog_ms}
    print(f"[jpeg] 12 MP host Huffman (C++, one thread): baseline "
          f"{base_ms:.1f} ms, progressive {prog_ms:.1f} ms")
    return figures


ARITH_FIXTURES = Path(__file__).resolve().parent / "tests" / "golden" \
    / "jpeg_arith"


def arith_case(big: bytes, coefs, dev, huffman_ms: dict) -> dict:
    """3i, arithmetic coding (A9c): the 12 MP photo re-coded by
    tools/jpeg_fixtures.arith_recode (libjpeg's jcarith.c) as SOF9 and as
    SOF10 (libjpeg's simple_progression): the C++ decoder's coefficients
    of each equal the baseline file's (``coefs``) bit for bit, and the card
    decode of each equals the baseline's at m = 8 and m = 2; the host
    arithmetic ms of both (``tools/decode_time.entropy_ms``, one thread)
    beside the Huffman ms.  Then every file of ``ARITH_FIXTURES`` (written
    by libjpeg's own compressor) through C++ -> J1 -> J2 on the card: its
    C++ coefficients equal data/decode.py's pure-Python arithmetic decode,
    exactly; its pixels at 64 px equal JAX's native path's in
    ``reference.npz``, without and with the prescale (the port applies the
    EXIF orientation, which that path ignores), bit for bit; the CMYK and
    YCCK ones, which that path refuses, are None there; where cv2's
    full-scale pixels are recorded, the imread route equals them resized.
    Returns the figures."""
    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.tools.decode_time import entropy_ms
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import arith_recode

    figures = {}
    t0 = time.perf_counter()
    coded = {"sof9": arith_recode(big, coefs),
             "sof10": arith_recode(big, coefs, progressive=True)}
    figures["arith_recode_s_12mp"] = time.perf_counter() - t0
    for name, blob in coded.items():
        same = all(np.array_equal(a, b)
                   for a, b in zip(J.coefficients(blob), coefs))
        print(f"[jpeg] 12 MP arithmetic re-code {name} ({len(blob)} bytes); "
              f"its C++ coefficients equal the baseline file's: {same}")
        check(same, f"the 12 MP {name} photo's coefficients differ")
    for m, pm in ((8, 0), (2, 2 * SERVE_DIM)):
        a, *rest = J.decode_blobs([big, *coded.values()], SERVE_DIM,
                                  "native", pm, dev)
        equal = all(b is not None and np.array_equal(a, b) for b in rest)
        print(f"[jpeg] 12 MP SOF9 and SOF10 card decode at m = {m} equal "
              f"the baseline's: {equal}")
        check(a is not None and equal,
              f"the arithmetic card decode differs at m = {m}")
    figures["arith_ms_12mp"] = {k: entropy_ms(b, 3) for k, b in coded.items()}
    print(f"[jpeg] 12 MP host entropy decode (C++, one thread): arithmetic "
          f"SOF9 {figures['arith_ms_12mp']['sof9']:.1f} ms, SOF10 "
          f"{figures['arith_ms_12mp']['sof10']:.1f} ms; Huffman baseline "
          f"{huffman_ms['baseline']:.1f} ms, progressive "
          f"{huffman_ms['progressive']:.1f} ms")
    ref = np.load(ARITH_FIXTURES / "reference.npz")
    paths = sorted(ARITH_FIXTURES.glob("*.jpg"))
    check(len(paths) >= 19, f"{len(paths)} arithmetic fixtures")
    blobs = [p.read_bytes() for p in paths]
    coef_ok = 0
    for path, blob in zip(paths, blobs):
        header = D.parse_jpeg(blob)
        same = all(np.array_equal(a, b) for a, b in zip(
            J.coefficients(blob, 8, None),
            D.jpeg_coefficients(blob, header, None)))
        coef_ok += same
        check(same, f"{path.name}: C++ coefficients differ from decode.py's")
    pix_ok = 0
    for key, pm in (("native64", 0), ("native64_pre", 128)):
        got = J.decode_blobs(blobs, 64, "native", pm, dev)
        for path, blob, img in zip(paths, blobs, got):
            want = ref.get(f"{path.stem}/{key}",
                           ref.get(f"{path.stem}/native64"))
            if want is None:
                ok = img is None
            else:
                want = D.apply_orientation(want, D.parse_jpeg(blob)
                                           .orientation)
                ok = img is not None and np.array_equal(img, want)
            pix_ok += ok
            check(ok, f"{path.name}: card pixels ({key}) differ from JAX's "
                  "native path")
    with_cv2 = [i for i, p in enumerate(paths) if f"{p.stem}/cv2" in ref]
    got = J.decode_blobs([blobs[i] for i in with_cv2], 64, "imread", 0, dev)
    for i, img in zip(with_cv2, got):
        want = D.resize_bilinear(ref[f"{paths[i].stem}/cv2"], 64, 64)
        ok = img is not None and np.array_equal(img, want)
        pix_ok += ok
        check(ok, f"{paths[i].name}: the imread route differs from cv2's")
    print(f"[jpeg] {len(paths)} libjpeg-written arithmetic fixtures: C++ "
          f"coefficients equal decode.py's in {coef_ok}; card pixels equal "
          f"reference.npz in {pix_ok} of {2 * len(paths) + len(with_cv2)} "
          f"(native 64 px without and with the prescale, imread vs cv2)")
    figures["arith_fixtures"] = dict(files=len(paths), coefficients=coef_ok,
                                     pixels=pix_ok)
    return figures


def _j2_samples(plan) -> int:
    """The plane samples J2's taps read (rows x columns each component
    reads, fancy neighbours included), for the bytes bound."""
    from aihab_clip_tpu_torch.ops import jpeg as J

    def needed(taps, ratio, fancy, size):
        t = np.unique(taps)
        if not fancy:
            return np.unique(t // ratio)
        y = t >> 1
        nb = np.where(t & 1, np.minimum(y + 1, size - 1), np.maximum(y - 1, 0))
        return np.unique(np.concatenate([y, nb]))

    total = 0
    for row, tx, ty in zip(plan.photos, plan.taps_x, plan.taps_y):
        check(row[J.PH_ORIENT] == 1, "J2's bytes count assumes no rotation")
        for k in range(row[J.PH_NCOMP]):
            _, _, dw, dh, hr, vr, mode = row[J.PH_SLOT + k * J.SLOT_FIELDS:
                                             J.PH_SLOT + (k + 1)
                                             * J.SLOT_FIELDS]
            box = mode == J.MODES["box"]
            cols = needed(tx[:, :2], hr if box else 1,
                          mode in (J.MODES["h2v1"], J.MODES["h2v2"]), dw)
            rows_ = needed(ty[:, :2], vr if box else 1,
                           mode in (J.MODES["h1v2"], J.MODES["h2v2"]), dh)
            total += len(cols) * len(rows_)
    return total


def jpeg_kernel_cases(timed, rows, big, mids, adobe) -> dict:
    """3i. The fast JPEG decode (ops/jpeg.py): csrc/jpeg_entropy.cpp's
    coefficients of the 12 MP JPEG against data/decode.py's pure-Python
    Huffman decode, exactly; the card decode of that photo at full scale
    and at m = 2 (the serving prescale) against the numpy pipeline on those
    coefficients, bit for bit; its progressive re-code (``progressive_case``);
    J1 and J2 against their plain versions (max |d| 0) with their times at
    the 12 MP (full, m = 2) and 1024 x 768 shapes resized to SERVE_DIM, and
    J2's four-component instance on the CMYK and YCCK photos ``adobe``;
    then, compared only, J1 at m = 4 and 1 and J2 at 4:2:2, 4:4:4, 4:4:0
    and gray.  Returns the figures."""
    import torch

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.data.encode import encode_jpeg
    from aihab_clip_tpu_torch.ops import jpeg as J

    dev = torch.device("cuda")
    figures = {}
    header = D.parse_jpeg(big)
    t0 = time.perf_counter()
    ref = D.jpeg_coefficients(big, header)
    figures["python_huffman_s_12mp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mine = J.coefficients(big)
    figures["cpp_huffman_s_12mp"] = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip(mine, ref))
    print(f"[jpeg] 12 MP coefficients: C++ {figures['cpp_huffman_s_12mp']:.3f}"
          f" s, data/decode.py's Huffman {figures['python_huffman_s_12mp']:.3f}"
          f" s; {sum(a.size for a in mine)} coefficients equal: {same}")
    check(same, "the C++ coefficients differ from data/decode.py's")
    full = D.reconstruct_jpeg(header, ref, 8)
    src = smoke_photo(*RUNNER_LARGE_JPEG, SEED)
    err = np.abs(full.astype(int) - src).mean()
    print(f"[jpeg] 12 MP decode vs the photo encoded: mean|d| {err:.3f} "
          f"(limit 8)")
    check(full.shape == src.shape and err < 8, "large JPEG decode")
    del src
    for m, pm in ((8, 0), (2, 2 * SERVE_DIM)):
        check(D.prescale_factor((header.width, header.height), pm) == m,
              "the 12 MP photo's prescale")
        want = D.resize_bilinear(full if m == 8 else D.reconstruct_jpeg(
            header, ref, m), SERVE_DIM, SERVE_DIM)
        got = J.decode_blobs([big], SERVE_DIM, "native", pm, dev)
        equal = got[0] is not None and np.array_equal(got[0], want)
        print(f"[jpeg] 12 MP card decode at m = {m} vs the numpy pipeline on "
              f"those coefficients: equal {equal}")
        check(equal, f"the card decode at m = {m} differs from numpy's")
    del ref, full
    figures.update(progressive_case(big, mine, dev))
    figures.update(arith_case(big, mine, dev, figures["huffman_ms_12mp"]))
    del mine

    def case(name, blobs, prescale_min, timing=True):
        hs = [D.parse_jpeg(b) for b in blobs]
        scales = [D.prescale_factor((h.width, h.height), prescale_min)
                  for h in hs]
        plan = J.plan_batch(hs, scales, SERVE_DIM)
        coef = torch.empty(plan.coef_total, dtype=torch.int16,
                           pin_memory=True)
        check(bool((J.entropy_decode(plan, blobs, coef) == 0).all()),
              f"{name}: entropy decode")
        coef_d = coef.to(dev)
        qt, segs, photos, tx, ty = (torch.from_numpy(a).to(dev) for a in (
            plan.qtables, plan.segs, plan.photos, plan.taps_x, plan.taps_y))
        planes = torch.zeros(plan.plane_total, dtype=torch.uint8, device=dev)
        planes_p = torch.zeros_like(planes)
        out = torch.zeros(len(blobs), SERVE_DIM, SERVE_DIM, 3,
                          dtype=torch.uint8, device=dev)
        out_p = torch.zeros_like(out)
        four = all(len(h.comps) == 4 for h in hs)
        j2 = "jpeg_color_resize_cmyk" if four else "jpeg_color_resize"
        j2_fn, j2_plain = getattr(J, j2), J.jpeg_color_resize_plain
        fns = {
            "jpeg_idct": (lambda: J.jpeg_idct(coef_d, qt, segs, planes)
                          or planes,
                          lambda: J.jpeg_idct_plain(coef_d, qt, segs,
                                                    planes_p) or planes_p),
            j2: (lambda: j2_fn(planes, photos, tx, ty, out) or out,
                 lambda: j2_plain(planes, photos, tx, ty, out_p) or out_p)}
        nb = plan.segs[:, J.SEG_NB]
        sizes = plan.segs[:, J.SEG_S]
        packed = np.array([J.PACKED[int(s_)] for s_ in sizes])
        work = {
            "jpeg_idct": (int((nb * np.array([J1_OPS[int(s_)] for s_ in sizes]))
                              .sum()),
                          int((2 * nb * packed + nb * sizes ** 2).sum())
                          + plan.qtables.nbytes),
            j2: (len(blobs) * SERVE_DIM ** 2 * (J2_CMYK_OPS if four
                                                 else J2_OPS),
                 len(blobs) * SERVE_DIM ** 2 * 3 + _j2_samples(plan)
                 + plan.taps_x.nbytes + plan.taps_y.nbytes)}
        for kname, (fn, plain) in fns.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            print(f"[jpeg] {kname}[{name}]: max|d| {err} (limit 0), scales "
                  f"{sorted(set(scales))}")
            check(err == 0, f"{kname}[{name}] differs from its plain version")
            if not timing:
                continue
            ms, plain_ms = timed(fn), timed(plain, iters=3)
            ops, nbytes = work[kname]
            t_ops, t_bytes = ops / PEAK_CORE_OPS, nbytes / PEAK_BYTES
            b_ms = 1e3 * max(t_ops, t_bytes)
            b_by = "operations" if t_ops >= t_bytes else "bytes"
            print(f"[jpeg] {kname}[{name}]: {ms:.4f} ms (plain {plain_ms:.4f},"
                  f" bound {b_ms:.4f} by {b_by}: {nbytes} bytes, {ops} integer"
                  f" ops)")
            rows.append(dict(name=f"{kname}[{name}]", route="cuda",
                             source=SRC_JPEG, replaces=JAX_JPEG,
                             launches=None,
                             counter=getattr(J, kname), path="serving",
                             max_abs_err=float(err), tol_max_abs=0.0,
                             rel_l2=0.0, tol_rel_l2=0.0, ms=ms,
                             tflops=ops / ms / 1e9, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None))
            figures[f"{kname}[{name}]_ms"] = ms
        torch.cuda.empty_cache()

    case("12MP 4:2:0 full", [big], 0)
    case("12MP 4:2:0 m=2", [big], 2 * SERVE_DIM)
    case("1024x768 4:2:0 full", mids[:1], 2 * SERVE_DIM)
    case("1024x768 CMYK, YCCK", adobe, 0)
    case("1024x768 m=4, m=1", [mids[0], mids[1]], 384, timing=False)
    case("1024x768 m=1", mids[2:3], 96, timing=False)
    small = smoke_photo(301, 257, SEED + 9)
    case("4:2:2, 4:4:4, 4:4:0, gray", [
        encode_jpeg(small, 85, (2, 1)), encode_jpeg(small, 85, (1, 1)),
        encode_jpeg(small, 85, (1, 2)), encode_jpeg(small[:, :, 0], 85)],
        0, timing=False)
    return figures


def decode_split(blob: bytes, dim: int, prescale_min: int, reps: int = 5):
    """One photo's decode, split: host ms (parse, plan, C++ Huffman), card
    ms (upload, J1, J2 on the decode stream; CUDA events), and the whole
    ``decode_blobs`` call's ms on the native route (host clock); medians of
    ``reps``."""
    import torch

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.ops import jpeg as J

    dev = torch.device("cuda")
    stream = torch.cuda.Stream(dev)
    host, card, whole = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        h = D.parse_jpeg(blob)
        plan = J.plan_batch([h], [D.prescale_factor((h.width, h.height),
                                                    prescale_min)], dim)
        coef = torch.empty(plan.coef_total, dtype=torch.int16,
                           pin_memory=True)
        J.entropy_decode(plan, [blob], coef)
        host.append(1e3 * (time.perf_counter() - t0))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            e0.record()
            J._pixels(plan, coef, 1, dim, dev)
            e1.record()
        stream.synchronize()
        card.append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        J.decode_blobs([blob], dim, "native", prescale_min, dev,
                       stream=stream)
        whole.append(1e3 * (time.perf_counter() - t0))
    return (statistics.median(host), statistics.median(card),
            statistics.median(whole))


def _post(url: str, wire: str, blobs, timeout: float = 600.0):
    """One POST /predict over urllib in one of the three wires."""
    import base64
    import urllib.request

    from aihab_clip_tpu_torch.serving import encode_binary_batch

    if wire == "raw":
        body, ctype = blobs[0], "image/jpeg"
    elif wire == "json":
        body = json.dumps({"images_b64": [base64.b64encode(b).decode()
                                          for b in blobs]}).encode()
        ctype = "application/json"
    else:
        body, ctype = encode_binary_batch(blobs), "application/x-aihab-batch"
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _check_answers(tag, answers, reqs, ref) -> float:
    """Every answer's top-1 is the reference's and its top-k probabilities
    within SERVE_PROB_TOL of it; returns the largest difference."""
    worst = 0.0
    for (code, payload), (_, idx) in zip(answers, reqs):
        check(code == 200 and len(payload["predictions"]) == len(idx),
              f"{tag}: a request failed ({code})")
        for pred, i in zip(payload["predictions"], idx):
            top = pred["topk"]
            check(top[0]["label"] == int(ref[i].argmax()),
                  f"{tag}: top-1 differs from classify_batch's")
            for rec in top:
                worst = max(worst, abs(rec["prob"] - float(ref[i][rec["label"]])))
    check(worst <= SERVE_PROB_TOL, f"{tag}: max|dprob| {worst}")
    return worst


def serving_path(engine, big, mids, adobe, smi: str):
    """8b. ``PredictServer(port=0)`` over the bf16 ViT-B/16 engine answers
    SERVE_ROUNDS rounds of a raw, a JSON and a binary request (the 12 MP,
    the 1024 x 768 JPEGs and the CMYK and YCCK ones, which JAX's server
    decodes by cv2 at full scale) from SERVE_CLIENTS urllib client
    threads: each answer against ``classify_batch`` of ``decode_bytes`` of
    the same blob (top-1 equal, max|dprob| <= SERVE_PROB_TOL), one J1
    launch a request and one launch of each J2 instance its photos need,
    12 K1 a batch, no decode failure; then, in one request, garbage and a
    JPEG cut in its frame header count as undecodable; a 1024 x 768 JPEG
    re-coded arithmetic-coded (SOF9, ``tools/jpeg_fixtures.arith_recode``),
    one cut in its scan (JAX's native path keeps both) and a good photo
    beside them are answered, the first two with the probabilities of
    ``classify_batch(decode_bytes(blob))``.  Images/s through HTTP, latency p50/p99, fill, and the decode
    split per photo.  Returns (launch counts, figures)."""
    from concurrent.futures import ThreadPoolExecutor

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.serving import PredictServer, ServerStats
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import arith_recode

    photos = [big] + list(mids) + list(adobe)
    four = [False] * (1 + len(mids)) + [True] * len(adobe)
    ref = np.stack([engine.classify_batch(engine.decode_bytes(b)[None])[0]
                    for b in photos])
    n = len(photos)
    reqs = []
    for r in range(SERVE_ROUNDS):
        reqs += [("raw", [r % n]), ("json", [(r + 1) % n, (r + 2) % n]),
                 ("binary", [(r + k) % n for k in range(4)])]
    server = PredictServer(engine, port=0, max_wait_ms=5.0, verbose=False,
                           warmup=False)
    server.serve_background()
    url = f"http://127.0.0.1:{server.server_port}"

    def send(req):
        return _post(url, req[0], [photos[i] for i in req[1]])

    cut = mids[0][:int(len(mids[0]) * 0.6)]
    cut_ref = engine.classify_batch(engine.decode_bytes(cut)[None])[0]
    arithmetic = arith_recode(mids[0])
    arith_ref = engine.classify_batch(engine.decode_bytes(arithmetic)[None])[0]
    try:
        send(reqs[2])        # a first request: streams, pinned staging
        server.stats = server.batcher.stats = ServerStats()
        bk.reset_launch_counts()
        J.reset_launch_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            answers = list(pool.map(send, reqs))
        wall = time.perf_counter() - t0
        counts = {**bk.launch_counts(), **J.launch_counts()}
        snap = server.stats.snapshot(engine.batch_size)
        sof = mids[0].index(b"\xff\xc0")
        bad = _post(url, "json", [b"not an image", cut, mids[0][:sof + 8],
                                  arithmetic, mids[0]])
        stats_after = server.stats.snapshot(engine.batch_size)
    finally:
        server.stop()
    images = sum(len(idx) for _, idx in reqs)
    worst = _check_answers("serving", answers, reqs, ref)
    batches = snap["batches"]
    print(f"[serving] {len(reqs)} requests, {images} images from "
          f"{SERVE_CLIENTS} threads in {wall:.3f}s: "
          f"{images / wall:.1f} images/s over HTTP ({smi}); latency "
          f"{snap['latency_ms']}; fill {snap['mean_batch_fill']} over "
          f"{batches} batches; max|dprob| vs classify_batch {worst:.3g}; "
          f"launches {counts}")
    j2 = sum(not all(four[i] for i in idx) for _, idx in reqs)
    j2_cmyk = sum(any(four[i] for i in idx) for _, idx in reqs)
    check(counts["jpeg_idct"] == len(reqs)
          and counts["jpeg_color_resize"] == j2
          and counts["jpeg_color_resize_cmyk"] == j2_cmyk > 0,
          "one J1 launch a request and one of each J2 instance it needs")
    check(counts["full_block_fused"] == 12 * batches, "12 K1 a batch")
    check(snap["decode_failures"] == 0, "decode failures on good photos")
    answers_bad = bad[1]["predictions"] if bad[0] == 200 else []
    check(len(answers_bad) == 5
          and answers_bad[0] == answers_bad[2] == {"error":
                                                   "undecodable image"}
          and stats_after["decode_failures"] == 2, "bad blobs not counted")
    check(answers_bad[4]["topk"][0]["label"] == int(ref[1].argmax()),
          "a good blob beside bad ones")
    for i, what, want in ((1, "cut to 60%", cut_ref),
                          (3, "arithmetic-coded (SOF9)", arith_ref)):
        top = answers_bad[i].get("topk", [{}])[0]
        print(f"[serving] a 1024x768 JPEG {what}: top-1 {top} (the engine's "
              f"decode_bytes: {int(want.argmax())}, {float(want.max()):.4f})")
        check(top.get("label") == int(want.argmax())
              and abs(top.get("prob", -1) - float(want.max()))
              <= SERVE_PROB_TOL, f"a JPEG {what} comes back with its "
              "probabilities")
    figures = {"images_per_s": images / wall, "requests": len(reqs),
               "images": images, "batches": batches,
               "fill": snap["mean_batch_fill"],
               "latency_ms": snap["latency_ms"], "max_abs_dprob": worst}
    for tag, blob, pm in (("12mp_m2", big, 2 * engine.decode_dim),
                          ("1024x768", mids[0], 2 * engine.decode_dim)):
        host, card, whole = decode_split(blob, engine.decode_dim, pm)
        figures[f"decode_{tag}"] = dict(host_ms=host, card_ms=card,
                                        call_ms=whole)
        print(f"[serving] decode {tag}: host (parse + C++ Huffman) "
              f"{host:.2f} ms, card (upload + J1 + J2) {card:.3f} ms, the "
              f"call {whole:.2f} ms ({smi})")
    return counts, figures


def serving_int8(engine, mids) -> dict:
    """8c. INT8_SERVE raw requests through ``PredictServer`` over the int8
    ViT-B/16 engine (K8 + 12 K14 a batch, no K1), answers against its
    ``classify_batch``; returns the launch counts."""
    from concurrent.futures import ThreadPoolExecutor

    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.serving import PredictServer

    ref = np.stack([engine.classify_batch(engine.decode_bytes(b)[None])[0]
                    for b in mids])
    reqs = [("raw", [i % len(mids)]) for i in range(INT8_SERVE)]
    server = PredictServer(engine, port=0, max_wait_ms=5.0, verbose=False,
                           warmup=False)
    server.serve_background()
    url = f"http://127.0.0.1:{server.server_port}"
    try:
        for mod in (bk, J, qm):
            mod.reset_launch_counts()
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            answers = list(pool.map(
                lambda req: _post(url, req[0], [mids[i] for i in req[1]]),
                reqs))
        counts = {**bk.launch_counts(), **J.launch_counts(),
                  **qm.launch_counts()}
        batches = server.stats.batches
    finally:
        server.stop()
    worst = _check_answers("serving int8", answers, reqs, ref)
    print(f"[serving int8] {len(reqs)} requests over {batches} batches; "
          f"max|dprob| {worst:.3g}; launches {counts}")
    check(counts["quant_matmul_fused"] == batches
          and counts["quant_full_block_fused"] == 12 * batches
          and counts["full_block_fused"] == 0, "int8 serving launches")
    return counts


LOADER_RSS_CODE = """
import sys
import threading
import time
from aihab_clip_tpu_torch.data.bulk_load import decode_files


def rss():
    with open("/proc/self/status") as f:
        return next(int(x.split()[1]) for x in f if x.startswith("VmRSS:"))


resize, paths = int(sys.argv[1]), sys.argv[2:]
decode_files(paths[:1], resize, prescale=True, device="cuda")
before = rss()
peak, done = [before], threading.Event()


def watch():
    while not done.is_set():
        peak[0] = max(peak[0], rss())
        time.sleep(0.002)


watcher = threading.Thread(target=watch)
watcher.start()
out = decode_files(paths, resize, prescale=True, device="cuda")
done.set()
watcher.join()
print(before, max(peak[0], rss()), sum(o is not None for o in out))
"""


def loader_peak_rss(big: bytes, resize: int, root: str, smi: str) -> dict:
    """The bulk loader's host memory: in a child process (its own address
    space: ``ru_maxrss`` would carry this process's peak across the exec),
    the RSS after the imports, the card's context and one warm decode, then
    the peak RSS (``VmRSS`` sampled every 2 ms) of ``decode_files``
    (prescale on) over LOADER_RSS_FILES hard links of the 12 MP JPEG.  The
    growth is what the loader holds at once: one chunk's raw bytes and
    staging, where reading the split first held every file's bytes."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from aihab_clip_tpu_torch.data.bulk_load import JPEG_CHUNK

    folder = Path(tempfile.mkdtemp(prefix="aihab_rss_"))
    first = folder / "0.jpg"
    first.write_bytes(big)
    paths = [str(first)]
    for i in range(1, LOADER_RSS_FILES):
        paths.append(str(folder / f"{i}.jpg"))
        os.link(first, paths[-1])
    try:
        out = subprocess.run(
            [sys.executable, "-c", LOADER_RSS_CODE, str(resize), *paths],
            cwd=root, capture_output=True, text=True, timeout=300)
    finally:
        shutil.rmtree(folder)
    check(out.returncode == 0, f"loader RSS child: {out.stderr[-2000:]}")
    before, after, decoded = map(int, out.stdout.split()[-3:])
    check(decoded == LOADER_RSS_FILES, "loader RSS child decoded all files")
    figures = dict(files=LOADER_RSS_FILES, chunk=JPEG_CHUNK,
                   file_bytes=len(big), rss_before_mib=before / 1024,
                   peak_rss_mib=after / 1024,
                   growth_mib=(after - before) / 1024,
                   split_bytes_mib=LOADER_RSS_FILES * len(big) / 2**20)
    print(f"[runner] loader peak RSS over {LOADER_RSS_FILES} x {len(big)} "
          f"byte 12 MP JPEGs (the split's bytes "
          f"{figures['split_bytes_mib']:.1f} MiB), resize {resize}, chunks "
          f"of {JPEG_CHUNK}: peak {figures['peak_rss_mib']:.1f} MiB, "
          f"{figures['growth_mib']:.1f} MiB over the warm process's "
          f"{figures['rss_before_mib']:.1f} MiB ({smi})")
    return figures


def _png_bytes(img: np.ndarray) -> bytes:
    """RGB uint8 [h, w, 3] -> a plain PNG (filter 0 rows), the card's
    machine having neither cv2 nor PIL."""
    import struct
    import zlib

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def mixed_formats(folder: str, index_name: str) -> dict:
    """8, the runner's tree: one train JPEG re-coded as a progressive JPEG
    (tools/jpeg_fixtures.py) and one rewritten as a PNG under .png (its
    index row renamed), so the folder takes JAX's cv2.imread route, where
    a progressive file stopped the port's loader before A9b."""
    import csv
    from pathlib import Path

    from aihab_clip_tpu_torch.data import decode as D
    from aihab_clip_tpu_torch.tools.jpeg_fixtures import progressive_recode

    names = sorted(p.name for p in Path(folder).glob("*.jpg"))
    prog, png = names[0], names[1]
    path = Path(folder) / prog
    path.write_bytes(progressive_recode(path.read_bytes()))
    path = Path(folder) / png
    new = png[:-4] + ".png"
    (Path(folder) / new).write_bytes(_png_bytes(D.decode_image(
        path.read_bytes())))
    path.unlink()
    index = Path(folder) / index_name
    with open(index, newline="") as f:
        rows = list(csv.reader(f))
    col = rows[0].index("file")
    for row in rows[1:]:
        if row[col] == png:
            row[col] = new
    with open(index, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    print(f"[runner] the train folder holds a progressive JPEG ({prog}) and "
          f"a PNG ({new}): JAX's cv2.imread route")
    return {"progressive": prog, "png": new}


def runner_path(bk, smi: str, big: bytes) -> dict:
    """The port's runner (``aihab_clip_tpu_torch.runner.run``, what ``python
    -m aihab_clip_tpu_torch`` calls) on a synthetic CS tree in a temporary
    directory: all 20 classes, 8 train and 3 test 64 px JPEGs each, written
    by the port's encoder, one train photo a progressive JPEG and one a PNG
    (``mixed_formats``); ``configs/base.yaml`` + ``cs.yaml`` through the
    port's ``load_configs`` with ``RUNNER_OPTS``.  The ProLIP run (openai
    backend, ViT-B/16 at full width, 3 cached views, the 7x7 grid search, 5
    epochs) is gated: the cached view 0 against the same augmented batches
    through K1's plain version in fp32 (cosine >= COS_MIN); K1 launches =
    12 x the batches encoded; the projector against ``train_projector`` on
    the CPU from the same cache arrays (rel L2 <= RUNNER_PROJ_REL) and the
    same grid pick; the test accuracy recomputed on the CPU.  The PEFT run
    (openclip backend, 2 epochs): finite losses, frozen leaves unchanged,
    K1 launches = 2 per step + 12 per eval batch.  Before them: the fast
    decode's ms per 64 px photo and for the 12 MP JPEG ``big`` at full
    scale and at the prescale, and the predict CLI over the test folder,
    its rows against a ViT-B/16 engine's.  Returns the figures."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.cache import (feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.cache.feature_cache import (
        augmentation_settings, view_generator)
    from aihab_clip_tpu_torch.config import load_configs
    from aihab_clip_tpu_torch.data import SplitView, make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.data.bulk_load import JPEG_CHUNK
    from aihab_clip_tpu_torch.models import fast_vit, load
    from aihab_clip_tpu_torch.ops.fast_warp import fast_train_transform
    from aihab_clip_tpu_torch.ops.preprocess import normalize_stats_for
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.ops.jpeg import decode_blobs
    from aihab_clip_tpu_torch.runner import run
    from aihab_clip_tpu_torch.serving import ClassifierEngine
    from aihab_clip_tpu_torch.taxonomy import CS_CLASSNAMES
    from aihab_clip_tpu_torch.tools.predict import main as predict
    from aihab_clip_tpu_torch.train.prolip import (ProjectorSpec, grid_search,
                                                   projector_accuracy,
                                                   train_projector)

    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="aihab_runner_")
    os.chdir(tmp)   # results_lr/, feat_cache_vis/, runs/ and the caches
    figures = {"card": smi}
    try:
        t0 = time.perf_counter()
        tree = make_synthetic_cs_dataset(
            tmp, name="cs_synth", classes=CS_CLASSNAMES,
            n_train_per_class=RUNNER_TREE[0], n_test_per_class=RUNNER_TREE[1],
            image_size=RUNNER_TREE[2],
            index_file_name="CS_Xplots_2019_23_NEW02OCT24.csv")
        figures["tree_write_s"] = time.perf_counter() - t0
        figures["tree_formats"] = mixed_formats(
            tree["train_dir"], "CS_Xplots_2019_23_NEW02OCT24.csv")
        files = sorted(Path(tree["train_dir"]).glob("*.jpg"))[:RUNNER_TIMED]
        blobs = [f.read_bytes() for f in files]
        resize = int(RUNNER_OPTS[RUNNER_OPTS.index(
            "data.preprocessing.resize") + 1])
        decode_blobs(blobs[:JPEG_CHUNK], resize, "native", 2 * resize, "cuda")
        t0 = time.perf_counter()
        for start in range(0, len(blobs), JPEG_CHUNK):
            decode_blobs(blobs[start:start + JPEG_CHUNK], resize, "native",
                         2 * resize, "cuda")
        figures["fast_decode_ms_per_64px_photo"] = \
            1e3 * (time.perf_counter() - t0) / len(blobs)
        h, w = RUNNER_LARGE_JPEG
        for m, pm in ((8, 0), (2, 2 * resize)):
            host, card, whole = decode_split(big, resize, pm)
            figures[f"fast_decode_12mp_m{m}"] = dict(
                host_ms=host, card_ms=card, call_ms=whole,
                s_per_megapixel=whole / 1e3 / (h * w / 1e6))
        print(f"[runner] fast decode to {resize}: "
              f"{figures['fast_decode_ms_per_64px_photo']:.3f} ms per 64 px "
              f"photo (chunks of {JPEG_CHUNK}); one {w}x{h} JPEG "
              f"({len(big)} bytes): full scale "
              f"{figures['fast_decode_12mp_m8']}, m = 2 (the prescale for "
              f"{resize}) {figures['fast_decode_12mp_m2']} ({smi})")
        figures["loader_rss"] = loader_peak_rss(big, LOADER_RSS_RESIZE,
                                                str(here), smi)

        # the predict CLI over the test folder, against the engine's rows
        t0 = time.perf_counter()
        pred_rows = predict(["--images", tree["test_dir"], "--model",
                             "random:ViT-B/16", "--out", "preds.csv"])
        figures["predict_cli_images_per_s"] = \
            len(pred_rows) / (time.perf_counter() - t0)
        eng = ClassifierEngine(model="random:ViT-B/16", device="cuda",
                               verbose=False)
        paths = [str(Path(tree["test_dir"]) / r["file_name"])
                 for r in pred_rows]
        probs = eng.classify_batch(np.stack(eng.decode_files(paths)))
        worst = max(abs(r["top1_prob"] - float(probs[i, r["top1_label"]]))
                    for i, r in enumerate(pred_rows))
        same = all(r["top1_label"] == int(probs[i].argmax())
                   for i, r in enumerate(pred_rows))
        print(f"[runner] predict CLI: {len(pred_rows)} rows, "
              f"{figures['predict_cli_images_per_s']:.1f} images/s incl. "
              f"the engine's build and the decode ({smi}); top-1 equal to "
              f"the engine's: {same}, max|dprob| {worst:.3g}")
        check(same and worst <= SERVE_PROB_TOL
              and Path("preds.csv").read_text().count("\n")
              == len(pred_rows) + 1, "predict CLI rows differ from the "
              "engine's")
        del eng

        opts = ["data.dataset_paths", repr(tree["dataset_paths"])] + RUNNER_OPTS
        cfg = load_configs(str(here / "configs/base.yaml"),
                           str(here / "configs/cs.yaml"), opts)
        bk.reset_launch_counts()
        J.reset_launch_counts()
        t0 = time.perf_counter()
        result = run(cfg, config_file="cs", device="cuda")
        torch.cuda.synchronize()
        figures["prolip_wall_s"] = time.perf_counter() - t0
        launches = bk.launch_counts()
        figures["jpeg_launches"] = J.launch_counts()
        n_photos = sum(len(list(Path(d).glob("*.jpg"))) for d in (
            tree["train_dir"], tree["test_dir"]))
        print(f"[runner] the loaders' fast decode: {figures['jpeg_launches']}"
              f" for {n_photos} photos in chunks of {JPEG_CHUNK}")
        check(figures["jpeg_launches"]["jpeg_idct"] > 0, "runner J1 launches")
        loaders, out = result["loaders"], result["prolip"]
        timings = result["timings"]
        views_n = int(cfg.aug_views)
        batches = (views_n * len(loaders.train) + len(loaders.val)
                   + len(loaders.test))
        print(f"[runner] ProLIP run in {figures['prolip_wall_s']:.2f}s: train "
              f"{loaders.train.num_samples}, val {loaders.val.num_samples}, "
              f"test {loaders.test.num_samples}; {batches} batches encoded; "
              f"launches {launches}")
        check(launches["full_block_fused"] == 12 * batches,
              f"runner K1 launches {launches['full_block_fused']} for "
              f"{batches} batches (want 12 each)")
        figures["prolip_k1_launches"] = launches["full_block_fused"]
        figures["prolip_batches"] = batches

        # the cached view 0 against K1's plain version in fp32, same pixels
        bundle = result["bundle"]
        model, config = bundle["model"], bundle["model"].config
        views, labels = read_preprojection_cache(feature_cache_dir(cfg),
                                                 views_n)
        check(all(v.dtype == np.float16 and v.shape == (
            loaders.train.num_samples, W) for v in views), "cache shapes")
        pack32 = fast_vit.pack_fastest(model, config, torch.float32)
        mean, std = normalize_stats_for(config)
        aug = augmentation_settings(cfg)
        cache_view = SplitView(loaders.train.dataset, loaders.train.indices,
                               loaders.train.batch_size)
        refs = []
        with mock.patch.object(fast_vit, "full_block_fused",
                               bk.full_block_fused_plain), \
                torch.inference_mode():
            for bi, batch in enumerate(cache_view.batches()):
                x = fast_train_transform(
                    torch.from_numpy(batch.images).cuda(),
                    view_generator(int(cfg.seed), 0, bi),
                    bundle["resolution"], dtype=torch.float32, mean=mean,
                    std=std, **aug)
                pre = fast_vit.vit_encode_block_fused(pack32, x, config)
                refs.append(pre[torch.from_numpy(batch.valid).cuda()])
        ref = torch.cat(refs).float()
        got = torch.from_numpy(views[0]).cuda().float()
        cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1)
        figures["view0_cos_min"] = cos.min().item()
        print(f"[runner] cached view 0 vs K1 plain fp32 on the same "
              f"augmented batches: cosine min {cos.min().item():.6f} mean "
              f"{cos.mean().item():.6f} over {len(cos)} rows")
        check(cos.min().item() >= COS_MIN, "cached view 0 cosine")
        del pack32, refs, ref, got

        # the projector and the grid pick against the CPU
        epochs = int(cfg.train_epoch)
        feat_bs = int(cfg.feat_batch_size or 0)
        tw_cpu = bundle["text_weights"].float().cpu()
        spec_cpu = ProjectorSpec.from_clip_model(model).to("cpu")
        cpu_lr, cpu_lam, _, cpu_accs = grid_search(
            views, labels, tw_cpu, spec_cpu, out["val_feats"],
            out["val_labels"], epochs, verbose=False, device="cpu",
            return_accs=True)
        proj_cpu, _ = train_projector(views, labels, tw_cpu, spec_cpu,
                                      out["lr"], out["lambda"], epochs,
                                      feat_batch_size=feat_bs, verbose=False,
                                      device="cpu")
        w_card = out["projector"].weight.float().cpu()
        rel = ((w_card - proj_cpu.weight).norm()
               / proj_cpu.weight.norm()).item()
        figures.update(lr=out["lr"], lam=out["lambda"], proj_rel_l2=rel,
                       grid_max_abs_acc_diff=float(np.abs(
                           np.asarray(out["grid_accs"]) - cpu_accs).max()))
        print(f"[runner] grid pick card (lr {out['lr']}, lambda "
              f"{out['lambda']}) vs CPU (lr {cpu_lr}, lambda {cpu_lam}); 49 "
              f"val accuracies max|d| {figures['grid_max_abs_acc_diff']:.4g};"
              f" projector rel L2 {rel:.3e} (limit {RUNNER_PROJ_REL:g})")
        check((cpu_lr, cpu_lam) == (out["lr"], out["lambda"]),
              "grid pick differs from the CPU's")
        check(rel <= RUNNER_PROJ_REL, "projector differs from the CPU's")
        acc_cpu = projector_accuracy(out["projector"].to("cpu"),
                                     out["test_feats"], out["test_labels"],
                                     tw_cpu)
        print(f"[runner] test accuracy {out['acc']:.4f} (CPU recompute "
              f"{acc_cpu:.4f}), loss {out['loss']}")
        check(acc_cpu == out["acc"] and np.isfinite(out["loss"]),
              "test accuracy recompute")
        figures["test_acc"] = out["acc"]
        figures["tip_adapter"] = tip_adapter_check(
            feature_cache_dir(cfg), views_n, model, bundle["text_weights"],
            out["val_feats"], out["val_labels"])
        figures["file_root"] = file_root_prolip(bk, smi, here, opts, views,
                                                labels, out)

        figures.update({
            "build_loaders_s": timings["build_loaders_s"],
            "cache_write_images_per_s": timings["cache_write_images"]
            / timings["cache_write_s"],
            "grid_search_s": timings["grid_search_s"],
            "train_projector_s": timings["train_projector_s"],
            "test_encode_images_per_s": timings["test_images"]
            / timings["test_encode_s"]})
        print(f"[runner] build_loaders {figures['build_loaders_s']:.3f} s; "
              f"cache write {figures['cache_write_images_per_s']:.1f} images/s"
              f" over {views_n} views; grid search "
              f"{figures['grid_search_s']:.3f} s (49 projectors per step); "
              f"train_projector "
              f"{figures['train_projector_s']:.4f} s; test encode "
              f"{figures['test_encode_images_per_s']:.1f} images/s ({smi})")
        del result, bundle, model, out, views
        torch.cuda.empty_cache()

        # PEFT through the same runner; per-epoch losses from the logger
        cfg2 = load_configs(str(here / "configs/base.yaml"),
                            str(here / "configs/cs.yaml"),
                            opts + RUNNER_PEFT_OPTS)
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        result = run(cfg2, config_file="cs", logger_mode="stdout",
                     device="cuda")
        torch.cuda.synchronize()
        figures["peft_wall_s"] = time.perf_counter() - t0
        launches = bk.launch_counts()
        peft, loaders = result["peft"], result["loaders"]
        epochs = int(cfg2.train_epoch)
        steps = epochs * len(loaders.train)
        evals = len(loaders.val) + 2 * len(loaders.test)  # val, test, cache
        print(f"[runner] PEFT run in {figures['peft_wall_s']:.2f}s ({steps} "
              f"steps); launches {launches}")
        check(launches["full_block_fused"] == 2 * steps + 12 * evals,
              f"PEFT K1 launches {launches['full_block_fused']} (want 2 per "
              f"step + 12 per eval batch)")
        # the run directory is named after the backbone, "/" and all (as in
        # JAX), so the log sits one level deeper for random:ViT-B/16
        logs = [json.loads(line) for p in Path("runs").rglob("log.jsonl")
                for line in p.read_text().splitlines()]
        losses = [r["train_loss"] for r in logs if "train_loss" in r]
        losses += [peft["val"]["loss"], peft["test"]["loss"]]
        check(len(losses) == epochs + 2 and all(np.isfinite(losses)),
              f"PEFT losses {losses}")
        fresh = dict(load(str(cfg2.open_clip_model), dtype=torch.bfloat16,
                          device="cuda").model.named_parameters())
        frozen = [n for n in fresh if not peft["mask"][n]]
        changed = [n for n in frozen
                   if not torch.equal(fresh[n], peft["params"][n])]
        moved = [n for n, t in peft["mask"].items()
                 if t and not torch.equal(fresh[n], peft["params"][n])]
        print(f"[runner] PEFT losses {[round(x, 4) for x in losses]}; "
              f"{len(frozen)} frozen leaves, {len(changed)} changed; "
              f"{len(moved)} trainable leaves moved; test top1 "
              f"{peft['test']['top1']:.4f}")
        check(not changed, f"frozen leaves changed: {changed[:5]}")
        check(len(moved) > 0, "no trainable leaf moved")
        figures.update(peft_s_per_epoch=peft["seconds"] / epochs,
                       peft_k1_launches=launches["full_block_fused"],
                       peft_losses=losses)
        print(f"[runner] PEFT {figures['peft_s_per_epoch']:.3f} s per epoch "
              f"(finetune wall incl. the final val + test) ({smi})")
        del result, peft, fresh
        torch.cuda.empty_cache()

        # one epoch of the same PEFT run with aug_impl: exact (the per-image
        # gather augment, ops/preprocess.train_transform)
        from aihab_clip_tpu_torch.ops import preprocess as P

        cfg3 = load_configs(str(here / "configs/base.yaml"),
                            str(here / "configs/cs.yaml"),
                            opts + RUNNER_PEFT_OPTS
                            + ["aug_impl", "exact", "train_epoch", "1"])
        calls = []
        real = P.train_transform

        def spy(*a, **k):
            calls.append(a[0].shape)
            return real(*a, **k)

        bk.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(P, "train_transform", spy):
            result = run(cfg3, config_file="cs", logger_mode="stdout",
                         device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peft, loaders = result["peft"], result["loaders"]
        steps = len(loaders.train)
        evals = len(loaders.val) + 2 * len(loaders.test)
        k1 = bk.launch_counts()["full_block_fused"]
        print(f"[runner] PEFT with aug_impl: exact, 1 epoch in {wall:.2f}s: "
              f"{len(calls)} train_transform calls for {steps} steps; K1 "
              f"{k1}; test loss {peft['test']['loss']:.4f} top1 "
              f"{peft['test']['top1']:.4f}")
        check(len(calls) == steps and k1 == 2 * steps + 12 * evals
              and np.isfinite(peft["test"]["loss"])
              and np.isfinite(peft["val"]["loss"]),
              "PEFT with aug_impl: exact")
        figures.update(peft_exact_aug_s=wall,
                       peft_exact_aug_test_loss=peft["test"]["loss"])
        del result, peft
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return figures


def tip_adapter_check(cache_dir, views_n: int, model, text_weights,
                      val_feats, val_labels) -> dict:
    """Tip-Adapter (``train/tip_adapter.py``) on the runner's ProLIP cache:
    the cache model from its ``views_n`` views projected by the tower's
    ``proj``, the (beta, alpha) grid search on the val split's projected
    features, on the card and on the CPU from the same arrays: the same
    best accuracy, and the logits at the CPU's pick within 1e-5 rel L2."""
    import torch

    from aihab_clip_tpu_torch.cache import read_preprojection_cache
    from aihab_clip_tpu_torch.train import tip_adapter as tip

    proj = model.visual.proj.detach().float().cpu().numpy()
    views, labels = read_preprojection_cache(cache_dir, views_n)
    q = np.asarray(torch.as_tensor(val_feats).float().cpu()) @ proj
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    labels_q = np.asarray(torch.as_tensor(val_labels).cpu())
    w = text_weights.float().cpu()
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        keys, values = tip.build_cache_model(
            lambda v: (views[v].astype(np.float32) @ proj, labels), views_n,
            w.shape[1], device=dev)
        qd, wd = torch.from_numpy(q).to(dev), w.to(dev)
        beta, alpha, acc = tip.search_hp_tip(qd, labels_q, keys, values, wd)
        # the logits at the CPU's pick on both devices
        logits = tip.tip_logits(qd, keys, values, wd,
                                out.get("cpu", {}).get("beta", beta),
                                out.get("cpu", {}).get("alpha", alpha))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = dict(beta=beta, alpha=alpha, acc=acc,
                        seconds=time.perf_counter() - t0,
                        logits=logits.float().cpu())
    rel = ((out["cuda"]["logits"] - out["cpu"]["logits"]).norm()
           / out["cpu"]["logits"].norm()).item()
    pick = {k: (out["cuda"][k], out["cpu"][k]) for k in ("beta", "alpha",
                                                          "acc")}
    print(f"[runner] Tip-Adapter on the cache ({views_n} views, "
          f"{len(labels)} keys): card (beta, alpha, acc) vs CPU {pick}; "
          f"logits at the CPU's pick rel L2 {rel:.3e} (limit 1e-5); search "
          f"{out['cuda']['seconds']:.3f} s on the card")
    check(pick["acc"][0] == pick["acc"][1] and rel <= 1e-5,
          "Tip-Adapter on the card differs from the CPU's")
    return dict(beta=pick["beta"][0], alpha=pick["alpha"][0],
                acc=pick["acc"][0], cpu_pick=(pick["beta"][1],
                                              pick["alpha"][1]),
                logits_rel_l2=rel, search_s=out["cuda"]["seconds"])


# ---------------------------------------------------------------------------
# A18 + A18b: what the JAX package writes (orbax checkpoints, the zarr
# cache store under scheme:// roots), through the port's own codecs
# ---------------------------------------------------------------------------


def host_cpu() -> str:
    """The host CPU's model and the cores this process may use (the host
    codecs' rates stand beside it); the architecture where the machine
    does not name its model."""
    import os
    import platform

    model = platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith(("model name", "cpu model")):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {len(os.sched_getaffinity(0))} cores"


def _orbax_leaves(tree, prefix=""):
    """{orbax name: array} of a payload tree read by ``utils/orbax``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        if v is not None and not (isinstance(v, (dict, tuple, list))
                                  and not v):
            out.update(_orbax_leaves(v, f"{prefix}{k}."))
    return out


def _bits_equal(a, b) -> bool:
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def jax_fixtures_path(smi: str) -> dict:
    """(c) the files JAX wrote (``tests/golden/jax_written``, by
    ``tests/make_jax_written_fixtures.py``), read with the codecs this
    machine's compiler built: the 20 libzstd frames (levels -5 to 22) by
    the SHA-256 of their output, the orbax checkpoint (a ViT tower and its
    Adam state) and the TensorStoreStore directory (blosc/LZ4, 8 dtypes)
    against the arrays recorded beside them, bit for bit.  Then the host
    codecs' rates on this machine's CPU: zstd decode of the committed
    frames, the raw-frame writer and its decode, XXH64, blosc/LZ4 compress
    and decompress of fp16 features."""
    import hashlib
    from pathlib import Path

    import torch

    from aihab_clip_tpu_torch.cache.array_store import open_store
    from aihab_clip_tpu_torch.ops import blosc, zstd
    from aihab_clip_tpu_torch.utils import load_checkpoint, orbax

    golden = Path(__file__).resolve().parent / "tests" / "golden" / \
        "jax_written"
    figures = {"card": smi, "host_cpu": host_cpu()}
    digests = json.loads((golden / "zstd.json").read_text())
    frames = {n: (golden / "zstd" / n).read_bytes() for n in digests}
    bad = [n for n, f in frames.items() if hashlib.sha256(
        zstd.decompress(f, name=n)).hexdigest() != digests[n]]
    print(f"[jax formats] {len(frames) - len(bad)} of {len(frames)} libzstd "
          f"frames (levels -5, 1, 3, 19, 22) decode to their SHA-256")
    check(not bad and len(frames) == 20, f"zstd frames differ: {bad}")
    want = np.load(golden / "orbax_ckpt.npz")
    got = _orbax_leaves(orbax.read_state(golden / "orbax_ckpt" / "state"))
    diff = [k for k in want.files if k not in got
            or not _bits_equal(got[k], want[k])]
    restored = load_checkpoint(golden / "orbax_ckpt")
    print(f"[jax formats] JAX's orbax checkpoint: {len(want.files) - len(diff)}"
          f" of {len(want.files)} arrays bit for bit; load_checkpoint: "
          f"{len(restored['params'])} parameters, Adam over "
          f"{len(restored['opt_state']['state'])}, epoch "
          f"{restored['meta']['epoch']}")
    check(not diff and sorted(got) == sorted(want.files)
          and restored["meta"]["epoch"] == 3, f"orbax arrays differ: {diff}")
    want_s = np.load(golden / "tensorstore_store.npz")
    store = open_store(f"file://{golden / 'tensorstore_store'}")
    diff_s = []
    for name in want_s.files:
        a = store.load(name)
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16).numpy().view(np.uint16)
        if not _bits_equal(a, want_s[name]):
            diff_s.append(name)
    print(f"[jax formats] JAX's TensorStoreStore: "
          f"{len(want_s.files) - len(diff_s)} of {len(want_s.files)} arrays "
          f"bit for bit")
    check(not diff_s, f"store arrays differ: {diff_s}")
    figures.update(zstd_frames=len(frames), orbax_arrays=len(want.files),
                   store_arrays=len(want_s.files))

    def rate(fn, nbytes, reps):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return nbytes * reps / (time.perf_counter() - t0) / 1e9

    rng = np.random.default_rng(SEED)
    decoded = sum(len(zstd.decompress(f)) for f in frames.values())
    weights = (rng.standard_normal(1 << 24) * 0.02).astype(np.float32)
    raw = zstd.compress_raw(weights)
    feats = rng.standard_normal((1 << 15, W)).astype(np.float16)
    frame = blosc.compress(feats, 2)
    rates = {
        "zstd_decode_libzstd_frames_gbps": rate(
            lambda: [zstd.decompress(f) for f in frames.values()], decoded,
            20),
        "zstd_write_raw_gbps": rate(lambda: zstd.compress_raw(weights),
                                    weights.nbytes, 3),
        "zstd_decode_raw_gbps": rate(lambda: zstd.decompress(raw),
                                     weights.nbytes, 3),
        "xxh64_gbps": rate(lambda: zstd.xxh64(weights), weights.nbytes, 5),
        "blosc_lz4_compress_gbps": rate(lambda: blosc.compress(feats, 2),
                                        feats.nbytes, 3),
        "blosc_lz4_decompress_gbps": rate(lambda: blosc.decompress(frame),
                                          feats.nbytes, 3),
        "blosc_lz4_ratio": len(frame) / feats.nbytes}
    print(f"[jax formats] host codecs on {figures['host_cpu']}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in rates.items())
          + f" ({smi})")
    figures["host_codecs"] = rates
    return figures


def file_root_prolip(bk, smi: str, here, opts, views, labels, out) -> dict:
    """(b) The runner's ProLIP run again with the cache under a
    ``file://`` root (``ZarrStore``: blosc/LZ4 chunks through
    ``ops/blosc.py``, as JAX's ``TensorStoreStore`` writes them): every
    cached view and the labels read back bit for bit against the local
    ``.npy`` run's, the same grid pick and the projector within
    ``RUNNER_PROJ_REL``; K1 encodes the views.  Then the store's write and
    read GB/s on the run's views and on the views tiled to
    ``CACHE_ROWS`` rows."""
    import os

    import torch

    from aihab_clip_tpu_torch.cache import (feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.cache.array_store import ZarrStore
    from aihab_clip_tpu_torch.config import load_configs
    from aihab_clip_tpu_torch.runner import run

    root = f"file://{os.getcwd()}/file_root"
    cfg = load_configs(str(here / "configs/base.yaml"),
                       str(here / "configs/cs.yaml"),
                       opts + ["root_path", root])
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    result = run(cfg, config_file="cs", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = bk.launch_counts()["full_block_fused"]
    cache = feature_cache_dir(cfg)
    got, got_labels = read_preprojection_cache(cache, len(views))
    same = np.array_equal(got_labels, labels) and all(
        _bits_equal(a, b) for a, b in zip(got, views))
    mine = result["prolip"]
    w, wf = out["projector"].weight.float().cpu(), \
        mine["projector"].weight.float().cpu()
    rel = ((w - wf).norm() / w.norm()).item()
    pick = (mine["lr"], mine["lambda"]) == (out["lr"], out["lambda"])
    print(f"[runner file://] ProLIP with the cache under {cache}: {wall:.2f}s,"
          f" K1 {k1}; {len(views)} views + labels bit for bit with the .npy "
          f"run: {same}; grid pick {(mine['lr'], mine['lambda'])} (same: "
          f"{pick}); projector rel L2 {rel:.3e}, bit for bit "
          f"{torch.equal(w, wf)}; test acc {mine['acc']:.4f}")
    check(str(cache).startswith("file://") and same, "file:// cache differs")
    check(pick and rel <= RUNNER_PROJ_REL, "file:// ProLIP differs")
    check(k1 > 0, "no K1 in the file:// ProLIP run")
    figures = {"card": smi, "host_cpu": host_cpu(), "k1_launches": k1,
               "wall_s": wall, "cache_bit_identical": same,
               "projector_rel_l2": rel, "test_acc": mine["acc"]}
    store = ZarrStore(f"file://{os.getcwd()}/gbps")
    tiled = [np.resize(v, (CACHE_ROWS, v.shape[1])) for v in views]
    for label, arrays in (("runner_views", views), ("tiled_views", tiled)):
        nbytes = sum(a.nbytes for a in arrays)
        t0 = time.perf_counter()
        for i, a in enumerate(arrays):
            store.save(f"{label}{i}", a)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [store.load(f"{label}{i}") for i in range(len(arrays))]
        read_s = time.perf_counter() - t0
        check(all(_bits_equal(a, b) for a, b in zip(back, arrays)),
              f"{label}: store round trip")
        stored = sum(p.stat().st_size for p in (store.kv.root).rglob("*")
                     if p.is_file() and p.relative_to(
                         store.kv.root).parts[0].startswith(label))
        figures[label] = dict(shape=[len(arrays), *arrays[0].shape],
                              bytes=nbytes, stored_bytes=stored,
                              write_gbps=nbytes / write_s / 1e9,
                              read_gbps=nbytes / read_s / 1e9)
        print(f"[runner file://] blosc/LZ4 store, {label} "
              f"{figures[label]['shape']} fp16: {nbytes / 1e6:.1f} MB -> "
              f"{stored / 1e6:.1f} MB, write "
              f"{figures[label]['write_gbps']:.3f} GB/s, read "
              f"{figures[label]['read_gbps']:.3f} GB/s (host "
              f"{figures['host_cpu']}; {smi})")
    return figures


def checkpoint_io(restored: dict, tmp: str, smi: str) -> dict:
    """(a) A ViT-B/16 fine-tune checkpoint (``restored``: its params and
    Adam state) written in JAX's layout by ``save_checkpoint`` and read by
    ``load_checkpoint``, bit for bit, timed, beside ``torch.save`` and
    ``torch.load`` of the same payload: bytes and seconds."""
    from pathlib import Path

    import torch

    from aihab_clip_tpu_torch.config import ConfigNode
    from aihab_clip_tpu_torch.utils import load_checkpoint, save_checkpoint

    cfg = ConfigNode({"root_path": tmp, "clip_backend": "openai",
                      "backbone": "ViT-B/16",
                      "finetune": {"save_model_dir": "io_ck"}})
    params, opt_state = restored["params"], restored["opt_state"]
    t0 = time.perf_counter()
    path = save_checkpoint(cfg, params, opt_state, epoch=9)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_checkpoint(path)
    read_s = time.perf_counter() - t0
    same = all(torch.equal(back["params"][n], t) for n, t in params.items())
    names = opt_state["param_groups"][0]["param_names"]
    back_names = back["opt_state"]["param_groups"][0]["param_names"]
    by_name = dict(zip(back_names, back["opt_state"]["state"].values()))
    same_opt = sorted(back_names) == sorted(names) and all(
        torch.equal(by_name[n][k], st[k]) for n, st in zip(
            names, opt_state["state"].values())
        for k in ("exp_avg", "exp_avg_sq", "step"))
    nbytes = sum(p.stat().st_size for p in (path / "state").rglob("*")
                 if p.is_file())
    pt = Path(tmp) / "payload.pt"
    t0 = time.perf_counter()
    torch.save({"params": params, "opt_state": opt_state}, pt)
    pt_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.load(pt, map_location="cpu", weights_only=True)
    pt_read_s = time.perf_counter() - t0
    figures = dict(card=smi, host_cpu=host_cpu(), bytes=nbytes,
                   write_s=write_s, read_s=read_s,
                   torch_save_bytes=pt.stat().st_size,
                   torch_save_s=pt_write_s, torch_load_s=pt_read_s,
                   params=len(params), adam_slots=len(names))
    print(f"[a10 resume] JAX's layout: {nbytes / 1e6:.1f} MB ({len(params)} "
          f"params, Adam over {len(names)}), save_checkpoint {write_s:.2f}s, "
          f"load_checkpoint {read_s:.2f}s, bit for bit {same and same_opt}; "
          f"torch.save {pt.stat().st_size / 1e6:.1f} MB in {pt_write_s:.2f}s, "
          f"torch.load {pt_read_s:.2f}s (host {figures['host_cpu']}; {smi})")
    check(same and same_opt, "the checkpoint's round trip differs")
    return figures


# ---------------------------------------------------------------------------
# A10: LoRA, checkpoints with resume and SIGTERM, the epoch regimes, the
# scanned + remat'd LoRA step, profile_dir
# ---------------------------------------------------------------------------


def _lora_keys(layers: int) -> set:
    """JAX's ``lora_adapters.npz`` keys for a CLIP tower pair of ``layers``
    blocks each, attention and MLP adapted on both towers
    (``aihab_clip_tpu/train/lora.py``'s targets, ``runner.py:439``'s
    keys), written out here from the architecture."""
    mods = ("attn/in_proj", "attn/out_proj", "mlp/c_fc", "mlp/c_proj")
    return {f"{tower}/transformer/resblocks_{i}/{mod}/kernel/{leaf}"
            for tower in ("visual", "text") for i in range(layers)
            for mod in mods for leaf in ("a", "b")}


def a10_runner_path(bk, smi: str) -> dict:
    """A10 on ViT-B/16 through the port's entry points, on a synthetic CS
    tree (``RUNNER_TREE``) in a temporary directory:
    (a) ``run()`` with ``RUNNER_PEFT_OPTS`` + LoRA (rank ``A10_LORA_RANK``,
    ``lora_mlp``, the text tower too under ``tune_text``), ``save_model``,
    ``checkpoint_interval 1``, 2 epochs: every base weight bit-identical
    after training, every adapter moved, ``lora_adapters.npz`` with JAX's
    keys and layouts, K1 = 12 per eval batch; ``ClassifierEngine(lora=)``
    on the test photos: max|dprob| 0 against an engine on the returned
    W_eff, feature cosine >= ``COS_MIN`` against K1's plain version on
    W_eff, 12 K1 a batch; the int8 engine with the same adapters (K8 + 12 K14 a batch),
    feature cosine against the bf16 LoRA engine's >= ``INT8_COS['fp32']``;
    (b) ``python -m aihab_clip_tpu_torch`` (3 epochs, partial unfreeze, the
    K1 prefix, ``checkpoint_interval 1``) sent SIGTERM after its first
    ``Train Epoch`` line exits 0 with an epoch checkpoint; a second CLI run
    with ``finetune.resume True`` finishes; its final parameters against
    an uninterrupted ``run()`` of the same config, bit for bit;
    (c) ``finetune`` on (a)'s loaders with ``device_dataset`` False, True
    and 'chunked' (3 chunks an epoch): per-epoch losses and the final
    parameters bit for bit, and the uploads of the split (``peft.upload``)
    per run: none per step.  Returns the figures."""
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.config import load_configs
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.models import fast_vit, load
    from aihab_clip_tpu_torch.ops import quant_matmul as qm
    from aihab_clip_tpu_torch.runner import run
    from aihab_clip_tpu_torch.serving import ClassifierEngine
    from aihab_clip_tpu_torch.taxonomy import CS_CLASSNAMES
    from aihab_clip_tpu_torch.train import lora, peft
    from aihab_clip_tpu_torch.utils import latest_checkpoint, load_checkpoint

    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="aihab_a10_")
    os.chdir(tmp)
    figures = {"card": smi}
    launches = {}
    try:
        tree = make_synthetic_cs_dataset(
            tmp, name="cs_synth", classes=CS_CLASSNAMES,
            n_train_per_class=RUNNER_TREE[0], n_test_per_class=RUNNER_TREE[1],
            image_size=RUNNER_TREE[2],
            index_file_name="CS_Xplots_2019_23_NEW02OCT24.csv")
        base = ["data.dataset_paths", repr(tree["dataset_paths"])] \
            + RUNNER_OPTS + RUNNER_PEFT_OPTS

        def config(*opts):
            return load_configs(str(here / "configs/base.yaml"),
                                str(here / "configs/cs.yaml"),
                                base + list(opts))

        # -- (a) LoRA through the runner
        cfg = config("finetune.lora_rank", str(A10_LORA_RANK),
                     "finetune.lora_mlp", "True", "finetune.save_model",
                     "True", "finetune.checkpoint_interval", "1",
                     "finetune.save_model_dir", f"{tmp}/ck_lora")
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        result = run(cfg, config_file="cs", logger_mode="off", device="cuda")
        torch.cuda.synchronize()
        figures["lora_run_s"] = time.perf_counter() - t0
        out, loaders = result["peft"], result["loaders"]
        model = result["bundle"]["model"]
        launches["lora_run"] = bk.launch_counts()
        evals = len(loaders.val) + 2 * len(loaders.test)  # val, test, cache
        print(f"[a10 lora] runner LoRA r={A10_LORA_RANK} run in "
              f"{figures['lora_run_s']:.2f}s: {out['report']['num_adapted_kernels']}"
              f" adapted kernels, {out['report']['lora_params']:,} trainable "
              f"params; launches {launches['lora_run']}; test loss "
              f"{out['test']['loss']:.4f} top1 {out['test']['top1']:.4f} "
              f"({smi})")
        check(launches["lora_run"]["full_block_fused"] == 12 * evals,
              f"LoRA run K1 launches {launches['lora_run']['full_block_fused']}"
              f" (want 12 per eval batch x {evals})")
        fresh = load(str(cfg.open_clip_model), dtype=torch.bfloat16,
                     device="cuda").model
        base_changed = [n for n, p in fresh.named_parameters()
                        if not torch.equal(p, model.get_parameter(n))]
        check(not base_changed, f"LoRA changed base weights {base_changed[:3]}")
        init = lora.lora_init(fresh, A10_LORA_RANK,
                              torch.Generator().manual_seed(int(cfg.seed)
                                                            + 7919),
                              towers=("visual", "text"), include_mlp=True)
        still = [n for n, ab in out["adapters"].items()
                 if torch.equal(ab["a"], init[n]["a"])
                 or not ab["b"].abs().max().item() > 0]
        check(not still and init.keys() == out["adapters"].keys(),
              f"adapters that did not move: {still[:3]}")
        npz = np.load(out["adapters_path"])
        width = fresh.config.vision_width
        check(set(npz.files) == _lora_keys(12)
              and npz["visual/transformer/resblocks_0/attn/in_proj/kernel/a"]
              .shape == (width, A10_LORA_RANK)
              and npz["visual/transformer/resblocks_0/mlp/c_fc/kernel/b"]
              .shape == (A10_LORA_RANK, 4 * width),
              "lora_adapters.npz keys or layouts differ from JAX's")
        print(f"[a10 lora] base weights bit-identical ({len(dict(fresh.named_parameters()))}"
              f" leaves); all {len(init)} adapters moved; "
              f"{Path(out['adapters_path']).name}: {len(npz.files)} arrays "
              f"with JAX's keys; checkpoint {Path(out['checkpoint_path']).name}")
        del fresh

        # ClassifierEngine(lora=) on the test photos
        paths = sorted(str(p) for p in Path(tree["test_dir"]).glob("*.jpg"))
        eng = ClassifierEngine(model=str(cfg.open_clip_model), device="cuda",
                               lora=out["adapters_path"], verbose=False)
        imgs = np.stack(eng.decode_files(paths))
        bk.reset_launch_counts()
        probs = eng.classify_batch(imgs)
        torch.cuda.synchronize()
        launches["lora_engine"] = bk.launch_counts()
        n_batches = -(-len(imgs) // eng.batch_size)
        check(launches["lora_engine"]["full_block_fused"] == 12 * n_batches,
              f"LoRA engine K1 launches {launches['lora_engine']}")
        ref = ClassifierEngine(model=str(cfg.open_clip_model), device="cuda",
                               verbose=False)
        with torch.no_grad():
            for name, p in ref.bundle.model.named_parameters():
                p.copy_(out["params"][name])
        ref._packed = fast_vit.pack_fastest(ref.bundle.model, ref.bundle.config,
                                            torch.bfloat16)
        d_ref = float(np.abs(probs - ref.classify_batch(imgs)).max())
        # K1's plain version on W_eff: the serving gate of the kernel
        # against its plain version is the feature cosine (COS_MIN)
        from aihab_clip_tpu_torch.ops.preprocess import eval_transform

        with torch.inference_mode():
            xb = eval_transform(torch.from_numpy(imgs).cuda(), eng.resolution,
                                dtype=torch.bfloat16)
            f_k = fast_vit.encode_image_fastest(
                eng.bundle.model, xb, eng.bundle.config, project=True,
                packed=eng._packed)[1].float()
            with mock.patch.object(fast_vit, "full_block_fused",
                                   bk.full_block_fused_plain):
                f_p = fast_vit.encode_image_fastest(
                    eng.bundle.model, xb, eng.bundle.config, project=True,
                    packed=eng._packed)[1].float()
                plain = eng.classify_batch(imgs)
        cos_p = torch.nn.functional.cosine_similarity(f_k, f_p, dim=-1)
        d_plain = float(np.abs(probs - plain).max())
        agree = float((probs.argmax(-1) == plain.argmax(-1)).mean())
        print(f"[a10 lora] ClassifierEngine(lora=) on {len(imgs)} test photos: "
              f"max|dprob| {d_ref:.3g} against an engine on the returned "
              f"W_eff; against K1 plain on W_eff: feature cosine min "
              f"{cos_p.min().item():.6f} (limit {COS_MIN}), max|dprob| "
              f"{d_plain:.3g}, top-1 agreement {agree:.4f}; launches "
              f"{launches['lora_engine']} ({smi})")
        check(d_ref == 0.0, "the LoRA engine differs from the W_eff engine")
        check(cos_p.min().item() >= COS_MIN,
              "the LoRA engine differs from K1 plain on W_eff")
        del ref

        # the int8 engine on the same adapters (merge, then quantize)
        eng8 = ClassifierEngine(model=str(cfg.open_clip_model), device="cuda",
                                lora=out["adapters_path"], quantize="int8",
                                verbose=False)
        bk.reset_launch_counts()
        qm.reset_launch_counts()
        with torch.inference_mode():
            xb = xb[:eng.batch_size]
            f8 = eng8._encode_int8(xb).float()
            torch.cuda.synchronize()
            launches["lora_engine_int8"] = {**bk.launch_counts(),
                                            **qm.launch_counts()}
            f16 = fast_vit.encode_image_fastest(
                eng.bundle.model, xb, eng.bundle.config, project=True,
                packed=eng._packed)[1].float()
        cos8 = torch.nn.functional.cosine_similarity(f8, f16, dim=-1)
        print(f"[a10 lora] int8 engine on the adapters: feature cosine to "
              f"the bf16 LoRA engine min {cos8.min().item():.6f} (limit "
              f"{INT8_COS['fp32']}); launches {launches['lora_engine_int8']} "
              f"({smi})")
        check(launches["lora_engine_int8"]["quant_matmul_fused"] == 1
              and launches["lora_engine_int8"]["quant_full_block_fused"] == 12
              and launches["lora_engine_int8"]["full_block_fused"] == 0,
              "int8 LoRA engine launches")
        check(cos8.min().item() >= INT8_COS["fp32"], "int8 LoRA cosine")
        figures.update(lora_engine_max_dprob=d_ref,
                       lora_plain_cos_min=cos_p.min().item(),
                       lora_plain_max_dprob=d_plain,
                       lora_int8_cos_min=cos8.min().item(),
                       lora_test_loss=out["test"]["loss"])
        del eng, eng8, xb

        # -- (c) the epoch regimes on (a)'s loaders and base weights
        bundle = result["bundle"]
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        per_step = int(np.prod(loaders.train.dataset.images.shape[1:])) \
            * loaders.train.batch_size
        steps = len(loaders.train)
        chunk_steps = -(-steps // A10_CHUNKS)
        n_chunks = -(-steps // chunk_steps)
        check(n_chunks >= 3, f"{n_chunks} chunks an epoch")
        regimes = {}
        for regime in (False, True, "chunked"):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start[n])
            rows = []

            class Log:
                def log(self, row):
                    rows.append(row)

            pcfg = peft.PEFTConfig(
                resolution=bundle["resolution"], num_classes=20,
                lr=float(cfg.lr_v), epochs=2, crop_mode="random",
                rotation=True, tune_text=True,
                num_templates=bundle["num_templates"],
                compute_dtype=torch.bfloat16, device_dataset=regime,
                device_chunk_bytes=chunk_steps * per_step)
            bk.reset_launch_counts()
            t0 = time.perf_counter()
            o = peft.finetune(model, loaders.train, None, loaders.test, pcfg,
                              prompt_tokens=bundle["prompt_tokens"],
                              unlocked_groups=11, unlocked_text_layers=1,
                              seed=int(cfg.seed), logger=Log(), verbose=False,
                              device="cuda")
            torch.cuda.synchronize()
            regimes[regime] = dict(
                losses=[r["train_loss"] for r in rows if "train_loss" in r],
                params={n: t.detach().clone() for n, t in o["params"].items()},
                test_loss=o["test"]["loss"], s=time.perf_counter() - t0,
                uploads=o["report"]["split_uploads"],
                k1=bk.launch_counts()["full_block_fused"])
        want = {False: 3 * steps * 2, True: 2 + 2 * 2,
                "chunked": 3 * n_chunks * 2}
        for regime, r in regimes.items():
            same = all(torch.equal(t, regimes[False]["params"][n])
                       for n, t in r["params"].items())
            print(f"[a10 regimes] device_dataset={regime!r}: losses "
                  f"{r['losses']}, test loss {r['test_loss']:.6f}, params "
                  f"bit-identical to the host loop: {same}; uploads of the "
                  f"split {r['uploads']} (want {want[regime]}: "
                  f"{steps} steps an epoch); K1 {r['k1']}; {r['s']:.2f}s "
                  f"({smi})")
            check(r["losses"] == regimes[False]["losses"] and same
                  and r["test_loss"] == regimes[False]["test_loss"],
                  f"device_dataset={regime!r} differs from the host loop")
            check(r["uploads"] == want[regime],
                  f"device_dataset={regime!r} uploads {r['uploads']}")
            check(r["k1"] > 0, "no K1 in the regime run")
        figures["regimes"] = {str(k): dict(losses=v["losses"], s=v["s"],
                                           uploads=v["uploads"])
                              for k, v in regimes.items()}
        launches["regimes_k1"] = regimes[True]["k1"]
        del result, model, bundle, start, regimes
        torch.cuda.empty_cache()

        # -- (b) resume and SIGTERM through the CLI
        opts_b = ["train_epoch", "3", "finetune.checkpoint_interval", "1",
                  "finetune.save_model", "True",
                  "finetune.cache_embeddings", "False"]
        ref_cfg = config(*opts_b, "finetune.save_model_dir", f"{tmp}/ck_ref")
        bk.reset_launch_counts()
        ref_out = run(ref_cfg, config_file="cs", logger_mode="off",
                      device="cuda")["peft"]
        launches["resume_ref_k1"] = bk.launch_counts()["full_block_fused"]
        want_params = {n: t.detach().cpu() for n, t in
                       ref_out["params"].items()}
        del ref_out
        cmd = [sys.executable, "-m", "aihab_clip_tpu_torch", "--base_config",
               str(here / "configs/base.yaml"), "--dataset_config",
               str(here / "configs/cs.yaml"), "--logger", "off", "--opts",
               *base, *opts_b, "finetune.save_model_dir", f"{tmp}/ck_int"]
        env = dict(os.environ, PYTHONPATH=str(here), PYTHONUNBUFFERED="1")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("Train Epoch: 1 /"):
                    proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        first_s = time.perf_counter() - t0
        text = "".join(lines)
        stopped = [ln for ln in lines if "interrupted after epoch" in ln]
        ck1 = latest_checkpoint(config("finetune.save_model_dir",
                                       f"{tmp}/ck_int"))
        print(f"[a10 resume] CLI run sent SIGTERM after 'Train Epoch: 1': "
              f"exit {rc} in {first_s:.1f}s; {stopped[-1].strip() if stopped else 'no interrupt line'}; "
              f"checkpoint {ck1.name if ck1 else None} ({smi})")
        check(rc == 0 and stopped and ck1 is not None,
              f"the interrupted CLI run: exit {rc}\n{text[-3000:]}")
        layout = sorted(p.name for p in (ck1 / "state").iterdir())
        print(f"[a10 resume] the epoch checkpoint's state/: {layout}")
        check({"manifest.ocdbt", "_METADATA", "d"} <= set(layout),
              "the epoch checkpoint is not in JAX's orbax layout")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["finetune.resume", "True"], cwd=tmp,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        second_s = time.perf_counter() - t0
        restored = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("[resume]")]
        check(proc.returncode == 0 and restored,
              f"the resumed CLI run: exit {proc.returncode}\n"
              f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        final = load_checkpoint(latest_checkpoint(config(
            "finetune.save_model_dir", f"{tmp}/ck_int")))
        got = final["params"]
        diff = [n for n in want_params if not torch.equal(got[n],
                                                          want_params[n])]
        flat_g = torch.cat([got[n].flatten().double() for n in want_params])
        flat_w = torch.cat([want_params[n].flatten().double()
                            for n in want_params])
        cos = torch.nn.functional.cosine_similarity(flat_g, flat_w,
                                                    dim=0).item()
        print(f"[a10 resume] {restored[0]}; resumed run exit "
              f"{proc.returncode} in {second_s:.1f}s, final epoch "
              f"{final['meta']['epoch']}; params against the uninterrupted "
              f"run: {len(want_params) - len(diff)} of {len(want_params)} "
              f"leaves bit-identical, max|d| "
              f"{(flat_g - flat_w).abs().max().item():.3g}, cosine {cos:.9f} "
              f"({smi})")
        check(final["meta"]["epoch"] == 3, "the resumed run did not finish")
        check(not diff, f"resumed params differ from the uninterrupted "
              f"run's in {diff[:5]}")
        figures.update(resume_bit_identical=not diff,
                       interrupted_run_s=first_s, resumed_run_s=second_s,
                       interrupted_at=stopped[-1].strip())
        figures["jax_layout"] = checkpoint_io(final, tmp, smi)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    figures["launches"] = launches
    return figures


def a10_so400m_path(engine, bk, smi: str) -> dict:
    """A10 on SO400M (the SigLIP engine's seeded weights): (d) one LoRA
    train step (rank ``A10_LORA_RANK`` on both towers' attention, B drawn
    N(0, 0.02) so every adapter has a gradient) with ``scan_blocks`` and
    ``scan_remat`` at batch 16 at 384 from 439x439 uint8, tune_text: the
    scanned encode's 27 blocks through K6 (forward twice with remat, once
    in the backward's recompute), the loss and the adapters' gradient
    cosine against the same step with K6 plain (``STEP_GATES['plain']``);
    the peak memory and ms of the step with ``scan_remat`` True and False;
    (e) ``finetune`` over ``A10_PROFILE_SPLITS`` with the same options and
    ``profile_dir``: a Chrome trace whose CUDA kernels name the flash
    attention kernel and the dq and dk/dv kernels; the base weights
    unchanged; the test split through K5/K4.  Returns the figures."""
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import build_text_head
    from aihab_clip_tpu_torch.ops import attention as att
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.train import lora
    from aihab_clip_tpu_torch.train.peft import (PEFTConfig, _build_loss_fn,
                                                 finetune, make_train_step,
                                                 step_generator)

    dev = torch.device("cuda")
    model, mcfg = engine.bundle.model, engine.bundle.config
    layers = mcfg.vision_layers

    def counts():
        return {**bk.launch_counts(), **att.launch_counts()}

    def reset():
        bk.reset_launch_counts()
        att.reset_launch_counts()

    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    tokens = build_text_head(model, prompts, 20, tpc,
                             context_length=mcfg.context_length)["prompt_tokens"]
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=PEFT_LR, epochs=1, crop_mode="random", rotation=True,
                     tune_text=True, num_templates=tpc,
                     compute_dtype=torch.bfloat16, fused_prefix=0,
                     scan_blocks=True, scan_remat=True,
                     lora_rank=A10_LORA_RANK)
    adapters = lora.lora_init(model, A10_LORA_RANK,
                              torch.Generator().manual_seed(SEED + 7919),
                              towers=("visual", "text"))
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for ab in adapters.values():
            ab["b"].copy_(0.02 * torch.randn(ab["b"].shape, generator=g))
    ds = synthetic_dataset(np.random.default_rng(SEED + 5),
                           sum(A10_PROFILE_SPLITS), PEFT_DECODE)
    n_tr, n_te = A10_PROFILE_SPLITS
    train_view = SplitView(ds, np.arange(n_tr), PEFT_B, shuffle=True,
                           seed=SEED)
    test_view = SplitView(ds, np.arange(n_tr, n_tr + n_te), PEFT_B)
    batch = next(train_view.batches(0))
    imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
        batch.images, batch.labels, batch.valid))
    flat = [t for ab in adapters.values() for t in (ab["a"], ab["b"])]

    def step_grads(c):
        loss_fn = _build_loss_fn(model, c, None, tokens)
        for t in flat:
            t.grad = None
        with lora.lora_applied(model, adapters, c.lora_alpha):
            loss, _ = loss_fn(imgs, labs, valid, step_generator(SEED, 0, 0))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), torch.cat([t.grad.float().flatten()
                                       for t in flat])

    reset()
    kern = step_grads(cfg)
    per_step = counts()
    print(f"[a10 so400m] LoRA r={A10_LORA_RANK} on {len(adapters)} kernels "
          f"({lora.lora_param_count(adapters):,} params), scan_blocks + "
          f"scan_remat, batch {PEFT_B} at {mcfg.image_resolution}: launches "
          f"in one step {per_step}")
    check(per_step["fused_attention_fwd"] == 2 * layers
          and per_step["fused_attention_bwd"] == layers,
          f"K6 launches in the remat'd scanned step {per_step}")
    with plain_kernels():
        reset()
        plain = step_grads(cfg)
        check(not any(counts().values()), f"plain step launched {counts()}")
    gate = check_step("a10 so400m", "plain", kern, plain, STEP_GATES["plain"])
    print(f"[a10 so400m] the step against K6 plain: loss rel |d| "
          f"{gate['loss_rel']:.3e}, gradient cosine {gate['grad_cos']:.6f} "
          f"({smi})")
    del plain

    # peak memory and ms of the step, remat on and off
    mem = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, scan_remat=remat)
        _, step = make_train_step(model, c, None, tokens, adapters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = timed_steps(step, imgs, labs, valid, None, 1)
        mem[remat] = dict(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                          step_ms=statistics.median(times), step_ms_all=times)
        print(f"[a10 so400m] scan_remat={remat}: train step median "
              f"{mem[remat]['step_ms']:.3f} ms over {len(times)} steps ("
              f"{', '.join(f'{t:.2f}' for t in times)}), peak memory "
              f"{mem[remat]['peak_gib']:.2f} GiB ({smi})")
    del step

    # (e) finetune with profile_dir
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    prof_dir = tempfile.mkdtemp(prefix="aihab_prof_")
    reset()
    t0 = time.perf_counter()
    out = finetune(model, train_view, None, test_view, cfg,
                   prompt_tokens=tokens, seed=SEED, verbose=False,
                   profile_dir=prof_dir, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = counts()
    steps = n_tr // PEFT_B
    print(f"[a10 profile] finetune LoRA + scan + remat, {steps} steps + "
          f"{n_te // PEFT_B} test batches in {wall:.2f}s; launches "
          f"{run_counts} ({smi})")
    check(run_counts["fused_attention_fwd"] == 2 * layers * steps
          and run_counts["fused_attention_bwd"] == layers * steps
          and run_counts["attn_block_split"] == layers * (n_te // PEFT_B)
          and run_counts["mlp_block_split"] == layers * (n_te // PEFT_B),
          "K6 / K5 / K4 launches in the profiled finetune")
    changed = [n for n, p in model.named_parameters()
               if not torch.equal(p, before[n])]
    check(not changed, f"LoRA finetune changed base weights {changed[:3]}")
    files = sorted(Path(prof_dir).glob("trace_*.json"))
    check(len(files) == 1, f"profile_dir holds {len(files)} traces")
    trace_mb = files[0].stat().st_size / 2 ** 20
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    # the demangled instance names: attention_bwd_kernel<72, false> is the
    # dq kernel, <72, true> the dk/dv kernel (csrc/fused_attention_bwd.cu)
    bwd = [re.search(r"attention_bwd_kernel<\s*72,\s*(\w+)", k)
           for k in kernels]
    found = {
        "flash_attention_kernel": sum("flash_attention_kernel" in k
                                      for k in kernels),
        "attention_bwd_kernel (dq)": sum(
            m is not None and m.group(1) in ("false", "0") for m in bwd),
        "attention_bwd_kernel (dk/dv)": sum(
            m is not None and m.group(1) in ("true", "1") for m in bwd)}
    n_steps_traced = sum(e.get("name") == "train_step"
                         and e.get("cat") == "user_annotation"
                         for e in events)
    print(f"[a10 profile] {files[0].name}: {trace_mb:.1f} MiB, "
          f"{len(events)} events, {len(kernels)} CUDA kernels, "
          f"{n_steps_traced} train_step regions; kernel events {found} "
          f"({smi})")
    check(all(found.values()), f"trace lacks K6's kernels: {found}")
    check(n_steps_traced == min(5, steps), "train_step regions in the trace")
    shutil.rmtree(prof_dir, ignore_errors=True)
    model.zero_grad(set_to_none=True)
    del before, adapters, flat
    torch.cuda.empty_cache()
    return dict(step_check=gate, memory={str(k): v for k, v in mem.items()},
                finetune_s=wall, trace_kernels=found, trace_mb=trace_mb,
                launches_step=per_step, launches_finetune=run_counts,
                test_loss=out["test"]["loss"], card=smi)


# ---------------------------------------------------------------------------
# A11: the ModifiedResNet towers.  No TPU kernel lies on them (the JAX
# package left the whole tower to XLA): the folded convs run on cuDNN


def rn_stages(folded, config):
    """The folded encode as timed stages: the stem (3 convs, the 2x2
    pool), each of the four stages, the attention pool + ``c_proj``."""
    from aihab_clip_tpu_torch.models import fast_resnet as fr

    return ([("stem", lambda x: fr.resnet_stem(folded, x))]
            + [(f"layer{s}", lambda x, s=s: fr.resnet_stage(folded, x,
                                                            config, s))
               for s in range(1, 5)]
            + [("attnpool", lambda x: fr.resnet_pool(folded, x, config,
                                                     project=True)[1])])


def rn_engine_check(tag: str, engine, smi: str, seed: int) -> dict:
    """The bf16 RN engine on one full batch of seeded photos: its folded
    encode (one ``resnet_encode_folded`` call a batch) against the fp32
    canonical tower (TF32 off) on the same card and images (cosine >=
    COS_MIN; the canonical module in bf16 beside it), the engine's top-1
    against the fp32 tower's (>= RN_TOP1_MIN); the spread of the fp32
    features and their cosine under 1e-3 input noise (>= RN_STABLE_MIN: a
    chaotic random tower would fail any bf16 encode); the batch's
    device-time split; end-to-end images/s and peak memory."""
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.models import fast_vit
    from aihab_clip_tpu_torch.ops.preprocess import (eval_transform,
                                                     normalize_stats_for)
    from aihab_clip_tpu_torch.tools.rn_gains import seeded_photos

    model, cfg, bs = engine.bundle.model, engine.bundle.config, \
        engine.batch_size
    images = seeded_photos(bs, engine.decode_dim, seed)
    batch = torch.from_numpy(images).cuda()
    mean, std = normalize_stats_for(cfg)
    ref_tower = copy.copy(model.visual)
    ref_tower.dtype = torch.float32
    with mock.patch.object(fast_vit, "resnet_encode_folded",
                           wraps=fast_vit.resnet_encode_folded) as folded:
        probs = engine.classify_batch(images)
    check(folded.call_count == 1, f"{tag}: {folded.call_count} folded "
          "encodes for one batch")
    with torch.inference_mode():
        xb = eval_transform(batch, engine.resolution, dtype=torch.bfloat16,
                            mean=mean, std=std)
        feats = fast_vit.encode_image_fastest(
            model, xb, cfg, project=True, packed=engine._packed)[1].float()
        canon = model.encode_image(xb, project=True)[1].float()
        x32 = eval_transform(batch, engine.resolution, mean=mean, std=std)
        ref = ref_tower(x32, project=True)[1]
        noise = torch.randn(x32.shape, device=x32.device,
                            generator=torch.Generator(x32.device).manual_seed(
                                seed))
        moved = ref_tower(x32 + 1e-3 * noise, project=True)[1]
        ref_probs = torch.softmax(100.0 * torch.nn.functional.normalize(
            ref, dim=-1) @ engine._text_weights, dim=-1).cpu().numpy()
    cos, cos_canon, stable = (
        torch.nn.functional.cosine_similarity(f, ref, dim=-1)
        for f in (feats, canon, moved))
    top1 = float((probs.argmax(-1) == ref_probs.argmax(-1)).mean())
    f = torch.nn.functional.normalize(ref, dim=-1)
    spread = (((f @ f.T).sum() - bs) / (bs * bs - bs)).item()
    print(f"[{tag}] bf16 folded engine vs the fp32 canonical tower ({bs} "
          f"images at {engine.resolution}): cosine min {cos.min().item():.6f}"
          f" mean {cos.mean().item():.6f} (limit {COS_MIN}); the bf16 "
          f"canonical module's min {cos_canon.min().item():.6f}; top-1 "
          f"agreement {top1:.4f} (limit {RN_TOP1_MIN}); mean pairwise cosine"
          f" of the fp32 features {spread:.4f}; the fp32 tower under 1e-3 "
          f"input noise: cosine min {stable.min().item():.6f} (limit "
          f"{RN_STABLE_MIN})")
    check(stable.min().item() >= RN_STABLE_MIN, f"{tag}: the random tower "
          "is chaotic, its bf16 comparison meaningless")
    check(cos.min().item() >= COS_MIN, f"{tag} cosine against fp32")
    check(top1 >= RN_TOP1_MIN, f"{tag} top-1 agreement with fp32")
    del ref_tower, ref, feats, canon, moved, x32, xb
    split, t_all = classify_split(
        engine, batch, rn_stages(engine._packed["folded_rn"], cfg), iters=3)
    print(f"[{tag}] batch {bs} device time: classify {t_all:.3f} ms; its "
          f"stages in one run {sum(split.values()):.3f} = " + " + ".join(
              f"{k} {v:.3f}" for k, v in split.items()) + f" ({smi})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rate = images_per_s(engine, bs, engine.decode_dim, n=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] classify_batch end-to-end at batch {bs}: {rate:.1f} "
          f"images/s, peak memory {peak:.2f} GiB ({smi})")
    return dict(cos_min=cos.min().item(), cos_mean=cos.mean().item(),
                canonical_bf16_cos_min=cos_canon.min().item(),
                fp32_noise_cos_min=stable.min().item(),
                top1_vs_fp32=top1, feature_spread=spread, classify_ms=t_all,
                split_ms=split, images_per_s=rate, batch=bs,
                resolution=engine.resolution, peak_gib=peak)


def resnet_paths(bk, smi: str, mids) -> dict:
    """A11. The ModifiedResNet towers at their published widths, random
    weights from a seed, BatchNorm statistics calibrated on 16 seeded photos
    with residual branch gains U(0, 0.2) (``tools/rn_gains.calibrate_bn_``:
    the random init collapses the features, unit gains make the tower
    chaotic; ``python -m aihab_clip_tpu_torch.tools.rn_gains`` shows both):

      * RN50's weights as OpenAI's ``RN50.pt`` (fp16 state dict, int64
        ``num_batches_tracked``) in a temporary directory (the zoo's cache
        root, deleted after): ``zoo.load`` of the file (``torch``) and again
        (``npz-cache``, the JAX-layout cache), each the fp16-rounded source
        parameters bit for bit;
      * ``ClassifierEngine`` on that file (batch 64, 224 px) and
        ``ClassifierEngine("random:RN50x64")`` (batch 16, 448 px, BatchNorm
        calibrated and the fold re-packed): ``rn_engine_check``; RN50 answers 4
        requests through ``PredictServer`` (one J1 and one J2 each);
      * one PEFT step on the RN50 engine's weights (unlocked_groups 2,
        tune_text, batch 16 at 224 from 439x439) against the fp32 step
        (``VIT_STEP_GATES["fp32"]``) and its time;
      * the openai runner on the file: the feature cache (2,048 wide), the
        grid search and ProLIP, its cached view 0 against the fp32
        canonical tower and its projector against the CPU's.
    Returns the figures."""
    import os
    import shutil
    import tempfile
    from pathlib import Path
    from unittest import mock

    import torch

    from aihab_clip_tpu_torch.cache import (feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.cache.feature_cache import (
        augmentation_settings, view_generator)
    from aihab_clip_tpu_torch.config import load_configs
    from aihab_clip_tpu_torch.data import SplitView, make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.models import (CLIP_ARCHS, build_text_head,
                                             fast_vit, zoo)
    from aihab_clip_tpu_torch.ops import jpeg as J
    from aihab_clip_tpu_torch.ops.fast_warp import fast_train_transform
    from aihab_clip_tpu_torch.ops.preprocess import normalize_stats_for
    from aihab_clip_tpu_torch.runner import run
    from aihab_clip_tpu_torch.serving import ClassifierEngine, PredictServer
    from aihab_clip_tpu_torch.taxonomy import CS_CLASSNAMES
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.tools.rn_gains import (calibrate_bn_,
                                                     seeded_photos)
    from aihab_clip_tpu_torch.train.peft import (PEFTConfig, build_lock_mask,
                                                 make_train_step,
                                                 peft_fused_prefix_len)
    from aihab_clip_tpu_torch.train.prolip import (ProjectorSpec, grid_search,
                                                   projector_accuracy,
                                                   train_projector)

    dev = torch.device("cuda")
    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    tmp = Path(tempfile.mkdtemp(prefix="aihab_rn_"))
    old_root = zoo.default_cache_root
    figures = {"card": smi}
    try:
        zoo.default_cache_root = lambda: tmp / "cache"
        # RN50 as OpenAI's .pt, loaded and loaded again from the cache
        t0 = time.perf_counter()
        src = zoo.load("random:RN50", device="cuda", seed=SEED).model
        calibrate_bn_(src, torch.from_numpy(seeded_photos(
            16, 224, SEED + 11)).to(dev), SEED + 11)
        sd = {k: v.cpu() for k, v in src.state_dict().items()}
        pt = str(tmp / "RN50.pt")
        torch.save({k: v.half() if v.is_floating_point() else v
                    for k, v in openai_state_dict(sd).items()}, pt)
        rounded = {k: v.half().float() for k, v in sd.items()}
        del src, sd
        figures["weights"] = w = {"write_s": time.perf_counter() - t0,
                                  "file_mb": os.path.getsize(pt) / 1e6,
                                  "loads": []}
        for want in ("torch", "npz-cache"):
            t0 = time.perf_counter()
            b = zoo.load(pt, dtype=torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            got = b.model.state_dict()
            same = got.keys() == rounded.keys() and all(
                torch.equal(got[k].cpu(), rounded[k]) for k in rounded)
            print(f"[resnet] RN50.pt load ({b.source}) in {load_s:.3f}s, "
                  f"{w['file_mb']:.1f} MB fp16; {len(got)} tensors equal to "
                  f"the fp16-rounded source: {same}")
            check(b.source == want and b.config == CLIP_ARCHS["RN50"] and same,
                  f"RN50.pt load: source {b.source}, parameters equal {same}")
            w["loads"].append(dict(source=b.source, load_s=load_s))
            del b, got
        with np.load(zoo._npz_cache_path(pt, tmp / "cache")) as npz:
            check(npz["visual/conv1/kernel"].shape == (3, 3, 3, 32)
                  and "visual/layer1_0/downsample_bn/var" in npz.files
                  and "visual/attnpool/c_proj/kernel" in npz.files
                  and not any("num_batches" in k for k in npz.files),
                  "the RN50 cache is not in JAX's layout")
        cached_cfg = json.loads(zoo._config_cache_path(
            pt, tmp / "cache").read_text())
        check(cached_cfg["vision_layers"] == [3, 4, 6, 3], "cached config")
        del rounded

        # the RN50 engine on the file, PredictServer, the PEFT step
        engine = ClassifierEngine(model=pt, batch_size=64, device="cuda",
                                  verbose=False)
        check(engine.bundle.source == "npz-cache"
              and set(engine._packed) == {"folded_rn"}, "RN50 engine")
        engine.warmup()
        figures["rn50"] = rn_engine_check("rn50", engine, smi, SEED + 13)
        ref = np.stack([engine.classify_batch(engine.decode_bytes(b)[None])[0]
                        for b in mids])
        reqs = [("raw", [0]), ("json", [1, 2]), ("binary", [0, 1, 2, 3]),
                ("binary", [3, 2])]
        server = PredictServer(engine, port=0, max_wait_ms=5.0,
                               verbose=False, warmup=False)
        server.serve_background()
        try:
            J.reset_launch_counts()
            url = f"http://127.0.0.1:{server.server_port}"
            answers = [_post(url, wire, [mids[i] for i in idx])
                       for wire, idx in reqs]
            jl = J.launch_counts()
        finally:
            server.stop()
        worst = _check_answers("resnet serving", answers, reqs, ref)
        check(jl["jpeg_idct"] == jl["jpeg_color_resize"] == len(reqs),
              f"RN50 server decode launches {jl}")
        print(f"[resnet] PredictServer over the RN50 engine: {len(reqs)} "
              f"requests answered, max|dprob| vs classify_batch {worst:.3g};"
              f" launches {jl}")
        figures["rn50"]["server_max_abs_dprob"] = worst

        model = engine.bundle.model
        mcfg = model.config
        check(peft_fused_prefix_len(mcfg, RN_PEFT_UNLOCKED, dev) == 0,
              "an RN tower has no fused prefix")
        prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
        tokens = build_text_head(model, prompts, 20, tpc)["prompt_tokens"]
        cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                         lr=PEFT_LR, epochs=1, crop_mode="random",
                         rotation=True, tune_text=True, num_templates=tpc,
                         compute_dtype=torch.bfloat16, fused_prefix=0)
        mask = build_lock_mask(model, mcfg.vision_layers,
                               mcfg.transformer_layers,
                               unlocked_groups=RN_PEFT_UNLOCKED,
                               tune_text=True, unlocked_text_layers=1)
        trainable = [(n, p) for n, p in model.named_parameters() if mask[n]]
        check(not any(n.endswith((".mean", ".var")) for n, _ in trainable)
              and {n.split(".")[1] for n, _ in trainable
                   if n.startswith("visual.")} == {
                  "attnpool", *(f"layer4_{i}" for i in range(3))},
              "RN lock mask at unlocked_groups 2")
        ds = synthetic_dataset(np.random.default_rng(SEED + 14), PEFT_B,
                               PEFT_DECODE)
        batch = next(SplitView(ds, np.arange(PEFT_B), PEFT_B).batches(0))
        imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
            batch.images, batch.labels, batch.valid))
        step_grads = step_grads_fn(model, trainable, tokens, imgs, labs,
                                   valid)
        kern = step_grads(cfg, None)
        vis_dt, txt_dt = model.visual.dtype, model.text.dtype
        model.visual.dtype = model.text.dtype = torch.float32
        try:
            fp32 = step_grads(dataclasses.replace(
                cfg, compute_dtype=torch.float32), None)
        finally:
            model.visual.dtype, model.text.dtype = vis_dt, txt_dt
        gate = check_step("resnet peft", "fp32", kern, fp32,
                          VIT_STEP_GATES["fp32"])
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        _, step = make_train_step(model, cfg, None, tokens)
        times = timed_steps(step, imgs, labs, valid, None, 1)
        figures["rn50_peft"] = dict(
            step_check=gate, step_ms=statistics.median(times),
            step_ms_all=times, trainable_leaves=len(trainable),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"[resnet peft] RN50 train step (unlocked_groups "
              f"{RN_PEFT_UNLOCKED}, tune_text, batch {PEFT_B}): median "
              f"{figures['rn50_peft']['step_ms']:.3f} ms over {len(times)}; "
              f"peak memory {figures['rn50_peft']['peak_gib']:.2f} GiB "
              f"({smi})")
        del engine, model, step, step_grads, kern, fp32, trainable
        torch.cuda.empty_cache()

        # the openai runner on RN50.pt: feature cache, grid search, ProLIP
        os.chdir(tmp)
        tree = make_synthetic_cs_dataset(
            tmp, name="cs_synth", classes=CS_CLASSNAMES,
            n_train_per_class=RUNNER_TREE[0], n_test_per_class=RUNNER_TREE[1],
            image_size=RUNNER_TREE[2],
            index_file_name="CS_Xplots_2019_23_NEW02OCT24.csv")
        opts = (["data.dataset_paths", repr(tree["dataset_paths"])]
                + RUNNER_OPTS + ["backbone", pt, "clip_cache_dir",
                                 str(tmp / "cache"), "train_epoch",
                                 str(RN_RUNNER_EPOCHS)])
        rcfg = load_configs(str(here / "configs/base.yaml"),
                            str(here / "configs/cs.yaml"), opts)
        with mock.patch.object(fast_vit, "resnet_encode_folded",
                               wraps=fast_vit.resnet_encode_folded) as fold:
            t0 = time.perf_counter()
            result = run(rcfg, config_file="cs", device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        loaders, out, bundle = (result["loaders"], result["prolip"],
                                result["bundle"])
        views_n = int(rcfg.aug_views)
        batches = (views_n * len(loaders.train) + len(loaders.val)
                   + len(loaders.test))
        print(f"[resnet runner] ProLIP on RN50.pt in {wall:.2f}s (source "
              f"{bundle['source']!r}): train {loaders.train.num_samples}, val "
              f"{loaders.val.num_samples}, test {loaders.test.num_samples}; "
              f"{fold.call_count} folded encodes for {batches} batches")
        check(bundle["source"] == "npz-cache" and fold.call_count == batches,
              "the runner's RN50 encodes")
        model, config = bundle["model"], bundle["model"].config
        views, labels = read_preprojection_cache(feature_cache_dir(rcfg),
                                                 views_n)
        check(all(v.dtype == np.float16 and v.shape == (
            loaders.train.num_samples, 2048) for v in views), "RN cache shapes")
        mean, std = normalize_stats_for(config)
        aug = augmentation_settings(rcfg)
        ref_tower = copy.copy(model.visual)
        ref_tower.dtype = torch.float32
        refs = []
        with torch.inference_mode():
            for bi, b in enumerate(SplitView(
                    loaders.train.dataset, loaders.train.indices,
                    loaders.train.batch_size).batches()):
                x = fast_train_transform(
                    torch.from_numpy(b.images).cuda(),
                    view_generator(int(rcfg.seed), 0, bi),
                    bundle["resolution"], dtype=torch.float32, mean=mean,
                    std=std, **aug)
                refs.append(ref_tower(x)[torch.from_numpy(b.valid).cuda()])
        cos = torch.nn.functional.cosine_similarity(
            torch.from_numpy(views[0]).cuda().float(), torch.cat(refs),
            dim=-1)
        print(f"[resnet runner] cached view 0 vs the fp32 canonical tower on "
              f"the same augmented batches: cosine min {cos.min().item():.6f}"
              f" over {len(cos)} rows")
        check(cos.min().item() >= COS_MIN, "RN cached view 0 cosine")
        del ref_tower, refs
        tw_cpu = bundle["text_weights"].float().cpu()
        spec_cpu = ProjectorSpec.from_clip_model(model).to("cpu")
        t0 = time.perf_counter()
        cpu_lr, cpu_lam, _ = grid_search(
            views, labels, tw_cpu, spec_cpu, out["val_feats"],
            out["val_labels"], RN_RUNNER_EPOCHS, verbose=False, device="cpu")
        proj_cpu, _ = train_projector(
            views, labels, tw_cpu, spec_cpu, out["lr"], out["lambda"],
            RN_RUNNER_EPOCHS, feat_batch_size=int(rcfg.feat_batch_size or 0),
            verbose=False, device="cpu")
        cpu_s = time.perf_counter() - t0
        w_card = out["projector"].weight.float().cpu()
        rel = ((w_card - proj_cpu.weight).norm()
               / proj_cpu.weight.norm()).item()
        acc_cpu = projector_accuracy(out["projector"].to("cpu"),
                                     out["test_feats"], out["test_labels"],
                                     tw_cpu)
        print(f"[resnet runner] grid pick card (lr {out['lr']}, lambda "
              f"{out['lambda']}) vs CPU (lr {cpu_lr}, lambda {cpu_lam}); "
              f"c_proj projector rel L2 {rel:.3e} (limit {RUNNER_PROJ_REL:g});"
              f" test accuracy {out['acc']:.4f} (CPU {acc_cpu:.4f}); the CPU "
              f"run {cpu_s:.1f}s")
        check((cpu_lr, cpu_lam) == (out["lr"], out["lambda"]),
              "RN grid pick differs from the CPU's")
        check(rel <= RUNNER_PROJ_REL and torch.equal(
            out["projector"].bias.cpu(), spec_cpu.bias),
              "RN projector differs from the CPU's")
        check(acc_cpu == out["acc"], "RN test accuracy recompute")
        timings = result["timings"]
        figures["rn50_runner"] = dict(
            wall_s=wall, view0_cos_min=cos.min().item(), proj_rel_l2=rel,
            lr=out["lr"], lam=out["lambda"], test_acc=out["acc"],
            cache_write_images_per_s=timings["cache_write_images"]
            / timings["cache_write_s"])
        del result, bundle, model, out, views
        os.chdir(cwd)
        torch.cuda.empty_cache()

        # RN50x64, the widest row, at 448
        t0 = time.perf_counter()
        engine = ClassifierEngine(model="random:RN50x64", batch_size=16,
                                  device="cuda", verbose=False)
        calibrate_bn_(engine.bundle.model, torch.from_numpy(seeded_photos(
            16, 448, SEED + 12)).to(dev), SEED + 12)
        engine._packed = fast_vit.pack_fastest(
            engine.bundle.model, engine.bundle.config, torch.bfloat16)
        engine.warmup()
        print(f"[resnet] RN50x64 engine built + warm in "
              f"{time.perf_counter() - t0:.1f}s")
        check(engine.resolution == 448 and engine.bundle.config.vision_layers
              == (3, 15, 36, 10), "RN50x64 engine")
        figures["rn50x64"] = rn_engine_check("rn50x64", engine, smi,
                                             SEED + 15)
        del engine
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        zoo.default_cache_root = old_root
        shutil.rmtree(tmp, ignore_errors=True)
    return figures


# ---------------------------------------------------------------------------
# the weights path: published checkpoint layouts, written from the port's
# state dicts (the CPU tests hold these writers against transformers and
# the JAX package's converters)


def openai_state_dict(sd):
    """The port's CLIP ViT or ModifiedResNet state dict -> OpenAI's names:
    the text tower at the top level; a ResNet's blocks as ``layer<s>.<b>``,
    ``downsample.0`` / ``.1``, each BatchNorm's statistics as
    ``running_mean`` / ``running_var`` beside an int64
    ``num_batches_tracked``, as torch's ``BatchNorm2d`` saves them."""
    import torch

    out = {}
    for k, v in sd.items():
        k = re.sub(r"^visual\.layer(\d)_(\d+)\.", r"visual.layer\1.\2.",
                   k.removeprefix("text."))
        k = k.replace(".downsample_conv.", ".downsample.0.").replace(
            ".downsample_bn.", ".downsample.1.")
        k = re.sub(r"\.(mean|var)$", r".running_\1", k)
        out[k] = v
        if k.endswith(".running_var"):
            out[k.removesuffix("running_var") + "num_batches_tracked"] = \
                torch.tensor(1000, dtype=torch.int64)
    return out


_CX_BLOCK = {"dwconv": "conv_dw", "norm": "norm", "fc1": "mlp.fc1",
             "fc2": "mlp.fc2", "gamma": "gamma"}


def openclip_convnext_state_dict(sd):
    """The port's ConvNeXt-CLIP state dict -> open_clip's names (timm's
    trunk, open_clip's head, OpenAI's text tower).  A head bias that is all
    zeros is left out, as open_clip exports the head (``proj_bias=False``)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] != "visual":
            out[k.removeprefix("text.")] = v
            continue
        mod, rest = parts[1], parts[2:]
        if mod in ("stem_conv", "stem_norm"):
            name = ["trunk.stem", "0" if mod == "stem_conv" else "1"]
        elif mod.startswith("down_"):
            kind, s = mod[len("down_"):].split("_")
            name = [f"trunk.stages.{s}.downsample",
                    "0" if kind == "norm" else "1"]
        elif mod.startswith("stage"):
            s, b = re.fullmatch(r"stage(\d+)_block(\d+)", mod).groups()
            name = [f"trunk.stages.{s}.blocks.{b}", _CX_BLOCK[rest[0]]]
            rest = rest[1:]
        elif mod == "head_norm":
            name = ["trunk.head.norm"]
        else:
            if rest == ["bias"] and not bool(v.any()):
                continue
            name = {"head_proj": ["head.proj"], "head_fc1": ["head.mlp.fc1"],
                    "head_fc2": ["head.mlp.fc2"]}[mod]
        out[".".join(["visual"] + name + rest)] = v
    return out


_HF_LAYER = {"attn": "self_attn", "ln_1": "layer_norm1", "ln_2": "layer_norm2",
             "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
_HF_NAMES = {
    "visual.positional_embedding":
        "vision_model.embeddings.position_embedding.weight",
    "visual.attnpool.probe": "vision_model.head.probe",
    "text.token_embedding.weight":
        "text_model.embeddings.token_embedding.weight",
    "text.positional_embedding":
        "text_model.embeddings.position_embedding.weight",
    "logit_scale": "logit_scale", "logit_bias": "logit_bias",
    **{f"{port}.{leaf}": f"{hf}.{leaf}" for port, hf in (
        ("visual.conv1", "vision_model.embeddings.patch_embedding"),
        ("visual.ln_post", "vision_model.post_layernorm"),
        ("visual.attnpool.attn.out_proj",
         "vision_model.head.attention.out_proj"),
        ("visual.attnpool.ln", "vision_model.head.layernorm"),
        ("visual.attnpool.mlp.c_fc", "vision_model.head.mlp.fc1"),
        ("visual.attnpool.mlp.c_proj", "vision_model.head.mlp.fc2"),
        ("text.ln_final", "text_model.final_layer_norm"),
        ("text.head", "text_model.head")) for leaf in ("weight", "bias")}}


def hf_siglip_state_dict(sd):
    """The port's SigLIP state dict -> transformers' ``SiglipModel`` names
    (the MAP head's q/k/v packed into ``in_proj_weight``/``in_proj_bias``,
    the scalar logit scale and bias as [1])."""
    import torch

    out = {}
    for k, v in sd.items():
        m = re.fullmatch(r"(visual|text)\.transformer\.resblocks\.(\d+)\."
                         r"(attn|ln_1|ln_2|mlp\.c_fc|mlp\.c_proj)\.(.+)", k)
        if m:
            tower = "vision_model" if m[1] == "visual" else "text_model"
            out[f"{tower}.encoder.layers.{m[2]}.{_HF_LAYER[m[3]]}.{m[4]}"] = v
        elif k in _HF_NAMES:
            out[_HF_NAMES[k]] = v.reshape(1) if v.dim() == 0 else v
    for leaf in ("weight", "bias"):
        out[f"vision_model.head.attention.in_proj_{leaf}"] = torch.cat(
            [sd[f"visual.attnpool.attn.{p}_proj.{leaf}"] for p in "qkv"])
    return out


def write_safetensors(path, tensors) -> None:
    """{name: tensor} -> a .safetensors file (header length, JSON header
    padded to 8 bytes, the tensors' bytes in order)."""
    import torch

    names = {torch.float32: "F32", torch.float16: "F16",
             torch.bfloat16: "BF16"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(
                torch.uint8).numpy())


def smoke_tokenizer_json(texts):
    """A Gemma-style byte-fallback BPE ``tokenizer.json`` whose merges
    build each word of ``texts`` (after the " " -> "▁" normalizer) from its
    characters; any other character falls back to its <0xNN> bytes."""
    specials = ["<pad>", "<eos>", "<bos>", "<unk>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    words = sorted({"▁" + w for t in texts for w in t.split()})
    for ch in sorted(set("".join(words))):
        vocab.setdefault(ch, len(vocab))
    merges = []
    for w in words:
        for i in range(2, len(w) + 1):
            if w[:i] not in vocab:
                vocab[w[:i]] = len(vocab)
                merges.append([w[:i - 1], w[i - 1]])
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [dict(id=i, content=t, single_word=False, lstrip=False,
                              rstrip=False, normalized=False, special=True)
                         for i, t in enumerate(specials)],
        "normalizer": {"type": "Replace", "pattern": {"String": " "},
                       "content": "▁"},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "<eos>", "type_id": 0}}],
            "pair": [{"Sequence": {"id": "A", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<eos>": {"id": "<eos>", "ids": [1],
                                         "tokens": ["<eos>"]}}},
        "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": True,
                  "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges}}


def write_hf_siglip_snapshot(root, repo, cfg, sd, dtype, shards, texts):
    """An HF hub snapshot of the port's SigLIP ``sd`` under ``root``
    (``root`` is then an ``HF_HOME``): ``SiglipModel`` safetensors in
    ``dtype`` (one file, or ``shards`` files and their index), a
    ``config.json`` without the keys that equal transformers' defaults, and
    a Gemma tokenizer (``smoke_tokenizer_json(texts)``, appending <eos>,
    right padding).  Returns the snapshot directory."""
    from pathlib import Path

    from aihab_clip_tpu_torch.models.convert_hf import (SIGLIP_TEXT_DEFAULTS,
                                                        SIGLIP_VISION_DEFAULTS)

    snap = (Path(root) / "hub" / f"models--{repo.replace('/', '--')}"
            / "snapshots" / "smoke")
    snap.mkdir(parents=True)
    hf = {k: v.to(dtype) for k, v in hf_siglip_state_dict(sd).items()}
    if shards == 1:
        write_safetensors(snap / "model.safetensors", hf)
    else:
        names = list(hf)
        cuts = np.array_split(np.arange(len(names)), shards)
        weight_map = {}
        for i, idx in enumerate(cuts):
            file = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
            part = {names[j]: hf[names[j]] for j in idx}
            write_safetensors(snap / file, part)
            weight_map.update(dict.fromkeys(part, file))
        total = sum(t.numel() * t.element_size() for t in hf.values())
        (snap / "model.safetensors.index.json").write_text(json.dumps(
            {"metadata": {"total_size": total}, "weight_map": weight_map}))
    text = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.text_width,
                intermediate_size=cfg.text_mlp_dim,
                num_hidden_layers=cfg.text_layers,
                num_attention_heads=cfg.text_heads,
                max_position_embeddings=cfg.context_length)
    vision = dict(hidden_size=cfg.vision_width,
                  intermediate_size=cfg.vision_mlp_dim,
                  num_hidden_layers=cfg.vision_layers,
                  num_attention_heads=cfg.vision_heads,
                  image_size=cfg.image_resolution, patch_size=cfg.patch_size)
    (snap / "config.json").write_text(json.dumps({
        "architectures": ["SiglipModel"], "model_type": "siglip",
        "text_config": {k: v for k, v in text.items()
                        if SIGLIP_TEXT_DEFAULTS[k] != v},
        "vision_config": {k: v for k, v in vision.items()
                          if SIGLIP_VISION_DEFAULTS[k] != v}}))
    (snap / "tokenizer.json").write_text(json.dumps(smoke_tokenizer_json(
        texts)))
    (snap / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "GemmaTokenizer", "add_bos_token": False,
         "add_eos_token": True, "padding_side": "right"}))
    (snap / "special_tokens_map.json").write_text(json.dumps(
        {"pad_token": "<pad>", "eos_token": "<eos>", "bos_token": "<bos>",
         "unk_token": "<unk>"}))
    return snap


@contextlib.contextmanager
def rss_peak():
    """Host RSS before the block and its peak inside it (VmRSS sampled
    every 5 ms), in MiB."""
    import threading

    def rss():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith("VmRSS")) / 1024

    out, peak, stop = {"before_mib": rss()}, [rss()], threading.Event()

    def watch():
        while not stop.wait(0.005):
            peak[0] = max(peak[0], rss())

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        yield out
    finally:
        stop.set()
        watcher.join()
        out["peak_mib"] = max(peak[0], rss())


def weights_path(source: str, engine, bk, smi: str) -> dict:
    """The weights path for one of the smoke's bundles (``source``:
    ``vit_b16``, ``so400m`` or ``convnext_base_w``): the engine's weights
    written in their published layout at full width in a temporary
    directory (an ``HF_HOME`` and the zoo's cache root, deleted after), then
    ``ClassifierEngine`` by the name a user gives (the ``.pt`` path, the
    hub names) against an engine on the source weights rounded to the
    file's dtype: probabilities equal bit for bit, the kernels (K1, K5/K4,
    K7) launched; the ``.pt`` and ConvNeXt files again from the cache
    (``npz-cache``, equal), none written for the SigLIP snapshot, whose
    text head takes the snapshot's tokenizer.  Load seconds (host clock),
    file sizes and host RSS."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    import aihab_clip_tpu_torch.models as models
    from aihab_clip_tpu_torch.models import zoo
    from aihab_clip_tpu_torch.models.siglip import SigLIPModel
    from aihab_clip_tpu_torch.serving import ClassifierEngine
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.tokenizer import tokenize
    from aihab_clip_tpu_torch.tokenizer.hf_json import load_hf_tokenizer

    dev = torch.device("cuda")
    cfg = engine.bundle.config
    src = {k: v.detach() for k, v in engine.bundle.model.state_dict().items()}
    dtype, kernels = {
        "vit_b16": (torch.float16, ("full_block_fused",)),
        "so400m": (torch.bfloat16, ("attn_block_split", "mlp_block_split")),
        "convnext_base_w": (torch.float32, ("convnext_mlp_block",))}[source]
    tmp = Path(tempfile.mkdtemp(prefix="aihab_weights_"))
    old_home, old_root, old_load = (os.environ.get("HF_HOME"),
                                    zoo.default_cache_root, models.load)
    loads = []

    def timed_load(*args, **kwargs):
        t0 = time.perf_counter()
        bundle = old_load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append((time.perf_counter() - t0, bundle.source))
        return bundle

    try:
        t0 = time.perf_counter()
        tokenizer = None
        if source == "vit_b16":
            name = str(tmp / "ViT-B-16.pt")
            torch.save({k: v.to(dtype).cpu()
                        for k, v in openai_state_dict(src).items()}, name)
            files = [Path(name)]
        elif source == "so400m":
            name = SL_HUB
            snap = write_hf_siglip_snapshot(
                tmp, SL_HF_REPO, cfg, src, dtype, WEIGHTS_SHARDS,
                gen_prompts(use_hierarchy=True, use_descriptive=True)[0][:10])
            files = sorted(snap.glob("*.safetensors"))
            tokenizer = load_hf_tokenizer(snap)
        else:
            name = f"hf-hub:{CX_HF_REPO}"
            snap = (tmp / "hub" / f"models--{CX_HF_REPO.replace('/', '--')}"
                    / "snapshots" / "smoke")
            snap.mkdir(parents=True)
            files = [snap / "open_clip_pytorch_model.bin"]
            torch.save({k: v.cpu() for k, v in
                        openclip_convnext_state_dict(src).items()}, files[0])
        write_s = time.perf_counter() - t0
        mb = sum(f.stat().st_size for f in files) / 1e6
        os.environ["HF_HOME"] = str(tmp)
        zoo.default_cache_root = lambda: tmp / "cache"

        # the reference: an engine on the source weights rounded to the
        # file's dtype
        rounded = {k: v.to(dtype).float() for k, v in src.items()}
        cls = SigLIPModel if source == "so400m" else models.CLIPModel
        models.load = lambda n, dtype=None, **kw: zoo.CLIPBundle(
            n, cfg, zoo._from_state_dict(cls, cfg, rounded, dtype, dev),
            "random", tokenizer)
        ref = ClassifierEngine(model=name, batch_size=B, device="cuda",
                               verbose=False)
        del rounded
        images = np.random.default_rng(SEED + 9).integers(
            0, 256, (B, ref.decode_dim, ref.decode_dim, 3), dtype=np.uint8)
        want = ref.classify_batch(images)
        del ref
        models.load = timed_load
        figures = dict(format={"vit_b16": "OpenAI state-dict .pt",
                               "so400m": "HF snapshot, safetensors",
                               "convnext_base_w": "open_clip .bin"}[source],
                       dtype=str(dtype).removeprefix("torch."),
                       files=len(files), file_mb=mb, write_s=write_s,
                       loads=[], card=smi)
        for attempt in range(1 if source == "so400m" else 2):
            with rss_peak() as rss:
                t0 = time.perf_counter()
                eng = ClassifierEngine(model=name, batch_size=B,
                                       device="cuda", verbose=False)
                engine_s = time.perf_counter() - t0
            load_s, got_source = loads[-1]
            check(eng.bundle.config == cfg, f"{source}: loaded config "
                  f"{eng.bundle.config} is not the source's {cfg}")
            bk.reset_launch_counts()
            probs = eng.classify_batch(images)
            launches = {k: bk.launch_counts()[k] for k in kernels}
            max_d = float(np.abs(probs - want).max())
            print(f"[weights] {source} load {attempt + 1} ({name}): source "
                  f"{got_source!r}, load {load_s:.3f}s, engine {engine_s:.3f}s"
                  f"; {len(files)} file(s) {mb:.1f} MB ({figures['dtype']}),"
                  f" written in {write_s:.3f}s; host RSS "
                  f"{rss['before_mib']:.0f} -> peak {rss['peak_mib']:.0f} MiB"
                  f"; probs max|d| {max_d:g} against the rounded source "
                  f"engine; launches {launches} ({smi})")
            want_source = ("hf-local" if attempt == 0 and source != "vit_b16"
                           else "torch" if attempt == 0 else "npz-cache")
            check(got_source == want_source, f"{source} load {attempt + 1}: "
                  f"source {got_source!r}, want {want_source!r}")
            check(np.array_equal(probs, want), f"{source} load {attempt + 1}:"
                  f" probabilities differ from the rounded source engine "
                  f"(max|d| {max_d})")
            check(all(launches.values()), f"{source}: kernels not launched "
                  f"on the loaded engine: {launches}")
            figures["loads"].append(dict(
                source=got_source, load_s=load_s, engine_s=engine_s,
                rss_before_mib=rss["before_mib"], rss_peak_mib=rss["peak_mib"],
                launches=launches))
            if source == "so400m":
                prompts = gen_prompts(use_hierarchy=True,
                                      use_descriptive=True)[0]
                ids = eng.bundle.tokenize_fn(prompts, cfg.context_length)
                check(eng.bundle.tokenize_fn is not None and np.array_equal(
                    ids, tokenizer(prompts, cfg.context_length)) and not
                    np.array_equal(ids, tokenize(prompts, cfg.context_length,
                                                 truncate=True)),
                      "the SigLIP text head does not take the snapshot's "
                      "tokenizer ids")
                check(not (tmp / "cache").exists(),
                      "a cache was written for a SigLIP snapshot")
            del eng
            torch.cuda.empty_cache()
        return figures
    finally:
        models.load, zoo.default_cache_root = old_load, old_root
        if old_home is None:
            os.environ.pop("HF_HOME", None)
        else:
            os.environ["HF_HOME"] = old_home
        shutil.rmtree(tmp, ignore_errors=True)


# A14: the tools.  No TPU kernel lies on them (JAX leaves k-means, PCA and
# t-SNE to scikit-learn and Canny to OpenCV on the host): the card runs
# them as torch ops, held against the port's own CPU run.
def _yaml_scalar(v) -> str:
    """A YAML 1.1 flow scalar or list (floats keep a '.', as YAML 1.1's
    float pattern wants)."""
    if isinstance(v, float):
        text = repr(v)
        if "e" in text and "." not in text:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    return "{}" if isinstance(v, dict) else json.dumps(v)


def yaml_text(cfg: dict, indent: int = 0) -> str:
    """A config tree as block YAML the port's reader reads back equal."""
    lines = []
    for k, v in cfg.items():
        if isinstance(v, dict) and v:
            lines += [" " * indent + f"{k}:", yaml_text(v, indent + 2)]
        else:
            lines.append(" " * indent + f"{k}: {_yaml_scalar(v)}")
    return "\n".join(lines)


def synthetic_embedding_cache(root, seed: int) -> set:
    """TOOLS_CACHE rows in the embedding cache's layout under ``root``: per
    class four modes around a class centre plus noise, unit rows; the
    classes' sizes TOOLS_BANDS and the rest, TOOLS_PLANTED of each class's
    rows (at least one) drawn from another class's modes.  Returns the
    planted rows' file names."""
    import csv
    from pathlib import Path

    from aihab_clip_tpu_torch.cache.embedding_cache import METADATA_COLUMNS
    from aihab_clip_tpu_torch.taxonomy import REASSIGN_LABEL_NAME_L3

    n, dim, classes = TOOLS_CACHE
    rng = np.random.default_rng(seed)
    rest, big = n - sum(TOOLS_BANDS), classes - len(TOOLS_BANDS)
    sizes = list(TOOLS_BANDS) + [rest // big + (i < rest % big)
                                 for i in range(big)]
    modes = rng.standard_normal((classes, 1, dim)) + 0.6 * rng.standard_normal(
        (classes, 4, dim))
    embs, labels, files, planted = [], [], [], set()
    for c, size in enumerate(sizes):
        x = modes[c, rng.integers(0, 4, size)] + 0.5 * rng.standard_normal(
            (size, dim))
        for j in range(max(1, round(size * TOOLS_PLANTED))):
            other = (c + 1 + int(rng.integers(0, classes - 1))) % classes
            x[j] = modes[other, rng.integers(0, 4)] + 0.5 * rng.standard_normal(
                dim)
            planted.add(f"c{c:02d}_{j:05d}.jpg")
        embs.append(x)
        labels += [c] * size
        files += [f"c{c:02d}_{j:05d}.jpg" for j in range(size)]
    order = rng.permutation(n)
    emb = np.concatenate(embs)[order]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    labels = np.asarray(labels, np.int32)
    root = Path(root)
    root.mkdir(parents=True)
    np.save(root / "embeddings.npy", emb.astype(np.float32))
    np.save(root / "labels.npy", labels[order])
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(METADATA_COLUMNS)
        for i in order:
            c = int(labels[i])
            w.writerow([files[i], c, REASSIGN_LABEL_NAME_L3[c], -1])
    (root / "meta.json").write_text(json.dumps(
        {"split": "test", "normalized": True, "num_samples": n, "dim": dim}))
    return planted


def _scores_against_cpu(tag, card, cpu, sim_col) -> dict:
    """The card's score table against the CPU's on the same cache: equal
    file sets, similarity columns within TOOLS_SIM_TOL, class_size and
    k_per_class equal, ranks and flags equal but between rows whose scores
    lie within TOOLS_SIM_TOL."""
    idx = {f: i for i, f in enumerate(cpu["file_name"].tolist())}
    check(sorted(idx) == sorted(card["file_name"].tolist()),
          f"{tag}: the card's rows are not the CPU's")
    at = np.asarray([idx[f] for f in card["file_name"].tolist()])
    worst = {}
    for col in (sim_col, "outlier_score", "margin_to_other_class"):
        if col in cpu:
            d = np.abs(card[col].astype(np.float64)
                       - cpu[col][at].astype(np.float64))
            worst[col] = float(np.nanmax(d)) if len(d) else 0.0
            check(worst[col] <= TOOLS_SIM_TOL, f"{tag}: {col} max|d| "
                  f"{worst[col]} > {TOOLS_SIM_TOL}")
    for col in ("class_size", "k_per_class", "ground_truth_num_label"):
        if col in cpu:
            check(np.array_equal(card[col], cpu[col][at]),
                  f"{tag}: {col} differs from the CPU's")
    score = cpu["outlier_score"].astype(np.float64)
    cls = cpu["ground_truth_num_label"]
    off = 0
    for col in ("rank_in_class", "is_bottom_5pct"):
        for i in np.flatnonzero(card[col] != cpu[col][at]):
            j = at[i]
            same = (cls == cls[j]) & (np.arange(len(cls)) != j)
            check(bool((np.abs(score[same] - score[j]) <= TOOLS_SIM_TOL)
                       .any()), f"{tag}: {col} of {card['file_name'][i]} "
                  "differs from the CPU's away from a tie")
            off += 1
    print(f"[tools] {tag}: card vs CPU max|d| {worst}; {off} rank/flag "
          f"differences, each inside a {TOOLS_SIM_TOL:g} tie")
    return dict(max_abs=worst, tie_differences=off)


def tools_path(smi: str, dev: str = "cuda") -> dict:
    """A14 (``tools/``, ``ops/{kmeans,tsne,edges}.py``) on the card.
    (1) ``run_grid`` over TOOLS_SWEEPS on the runner's synthetic CS tree
    (random:ViT-B/16 at 224, RUNNER_OPTS + RUNNER_PEFT_OPTS in a temporary
    base config): every combination in the CSV, sorted by top1_acc, finite
    metrics; ``run_ft_sweep`` as a subprocess with two overrides: exit 0,
    its overrides and ``sweep_run_name``.  (2) The first grid run's test
    embedding cache (K1 through ``encode_image_fastest``) and a synthetic
    one (TOOLS_CACHE).  (3) ``cs_clean_testset score``, single and multi,
    on both, against the CPU's (``_scores_against_cpu``), each class's
    k-means inertia against the CPU's from the card's initial centres, the
    planted recall.  (4) ``feat_vis --method tsne --pca_dim 50`` on the
    synthetic cache: finite, the final KL below the KL after exaggeration,
    the 10-NN label agreement at least the PCA-2 init's; on TOOLS_TSNE_DRAW
    rows P and the final KL against the CPU.  (5) ``canny_rgb`` and
    ``edge_blend`` on TOOLS_CANNY photos and the 12 MP photo, bit for bit
    with the CPU.  ``dev="cpu"`` rehearses the path on the CPU (every
    comparison then holds the CPU against itself).  Returns the figures."""
    import os
    import shutil
    import tempfile
    from pathlib import Path

    import torch

    from aihab_clip_tpu_torch.cache import embedding_cache_dir
    from aihab_clip_tpu_torch.cache import load_embedding_cache
    from aihab_clip_tpu_torch.config import (load_configs, safe_load,
                                             set_by_dotted_path)
    from aihab_clip_tpu_torch.data import make_synthetic_cs_dataset
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.ops import edges, tsne
    from aihab_clip_tpu_torch.ops.kmeans import kmeans
    from aihab_clip_tpu_torch.taxonomy import CS_CLASSNAMES
    from aihab_clip_tpu_torch.tools import cs_clean_testset, feat_vis
    from aihab_clip_tpu_torch.tools.outlier_cleaning import \
        MultiPrototypeScorer
    from aihab_clip_tpu_torch.tools.run_ft_sweep import sweep_run_name
    from aihab_clip_tpu_torch.tools.run_grid import expand_grid, run_grid
    from aihab_clip_tpu_torch.tools.table import Table

    here = Path(__file__).resolve().parent
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp(prefix="aihab_tools_")
    os.chdir(tmp)   # feat_cache_vis/, runs/ and the grid CSVs
    figures = {"card": smi}

    def sync_s(t0):
        if dev == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    try:
        # ---- (1) the sweeps
        tree = make_synthetic_cs_dataset(
            tmp, name="cs_synth", classes=CS_CLASSNAMES,
            n_train_per_class=RUNNER_TREE[0], n_test_per_class=RUNNER_TREE[1],
            image_size=RUNNER_TREE[2],
            index_file_name="CS_Xplots_2019_23_NEW02OCT24.csv")
        base_cfg = load_configs(str(here / "configs/base.yaml"),
                                str(here / "configs/cs.yaml"),
                                ["data.dataset_paths",
                                 repr(tree["dataset_paths"])]
                                + RUNNER_OPTS + RUNNER_PEFT_OPTS)
        base = Path(tmp) / "base.yaml"
        base.write_text(yaml_text(base_cfg) + "\n")
        figures["sweeps"] = []
        first_cfg = None
        for sweep_file, limit in TOOLS_SWEEPS:
            out = Path(tmp) / f"grid_{Path(sweep_file).stem}.csv"
            bk.reset_launch_counts()
            t0 = time.perf_counter()
            rows = run_grid(str(here / sweep_file), str(base), str(base),
                            limit=limit, out_csv=str(out), device=dev)
            wall = sync_s(t0)
            k1 = bk.launch_counts()["full_block_fused"]
            table = Table.read_csv(out)
            combos = expand_grid(safe_load(
                (here / sweep_file).read_text()))[:limit]
            print(f"[tools] run_grid {sweep_file} --limit {limit}: "
                  f"{wall:.2f}s, K1 {k1}; CSV ({smi}):")
            print((out.read_text()).rstrip())
            top1 = table["top1_acc"].astype(np.float64)
            metrics = np.stack([table[c].astype(np.float64) for c in (
                "top1_acc", "top3_acc", "f1", "mcc", "loss")])
            check(len(table) == len(rows) == limit and sorted(
                table["run"].tolist()) == sorted(r["run"] for r in rows)
                and all(any(all(r[k] == v for k, v in c.items())
                            for r in rows) for c in combos),
                f"{sweep_file}: the CSV lacks a combination")
            check(bool((np.diff(top1) <= 0).all())
                  and bool(np.isfinite(metrics).all())
                  and (k1 > 0 or dev == "cpu"),
                  f"{sweep_file}: the CSV is not sorted by top1_acc or has "
                  "a non-finite metric")
            figures["sweeps"].append(dict(
                sweep=sweep_file, combinations=limit, seconds=wall,
                k1_launches=k1, rows=[{k: table[k][i].item() if hasattr(
                    table[k][i], "item") else table[k][i]
                    for k in table.columns} for i in range(len(table))]))
            if first_cfg is None:
                first_cfg = load_configs(str(base), str(base))
                for k, v in combos[0].items():
                    set_by_dotted_path(first_cfg, k, v)

        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "aihab_clip_tpu_torch.tools.run_ft_sweep",
             "--base_config", str(base), "--dataset_config", str(base),
             "--finetune.unlocked_layers=5", "--seed=2", "--device", dev,
             "--logger", "stdout"],
            cwd=tmp, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(here)))
        sweep_cfg = load_configs(str(base), str(base))
        for k, v in (("finetune.unlocked_layers", "5"), ("seed", "2")):
            set_by_dotted_path(sweep_cfg, k, v)
        name = sweep_run_name(sweep_cfg)
        figures["run_ft_sweep_s"] = time.perf_counter() - t0
        print(f"[tools] run_ft_sweep subprocess: exit {proc.returncode} in "
              f"{figures['run_ft_sweep_s']:.2f}s; run name {name}")
        check(proc.returncode == 0, "run_ft_sweep failed: "
              + proc.stdout[-2000:] + proc.stderr[-2000:])
        check("[sweep] overrides: {'finetune.unlocked_layers': '5', "
              "'seed': '2'}" in proc.stdout
              and f"[sweep] run name: {name}\n" in proc.stdout,
              "run_ft_sweep printed other overrides or another run name")

        # ---- (2) the caches
        peft_cache = Path(embedding_cache_dir(first_cfg, "test"))
        synth_cache = Path(tmp) / "synthetic_cache"
        t0 = time.perf_counter()
        planted = synthetic_embedding_cache(synth_cache, SEED)
        figures["synthetic_cache_write_s"] = time.perf_counter() - t0
        check((peft_cache / "embeddings.npy").is_file(),
              f"the PEFT run wrote no embedding cache at {peft_cache}")

        # ---- (3) scoring, card against the CPU
        figures["scores"] = {}
        for cache_tag, cache in (("peft", peft_cache),
                                 ("synthetic", synth_cache)):
            for scorer in ("single", "multi"):
                tag = f"{cache_tag} {scorer}"
                argv = ["score", "--cache_dir", str(cache), "--scorer",
                        scorer]
                t0 = time.perf_counter()
                card = cs_clean_testset.main(argv + ["--device", dev])
                score_s = sync_s(t0)
                cpu = cs_clean_testset.main(argv + ["--device", "cpu"])
                sim = ("sim_to_centroid" if scorer == "single"
                       else "sim_to_prototype")
                fig = _scores_against_cpu(tag, card, cpu, sim)
                fig["score_s"] = score_s
                if cache_tag == "synthetic":
                    flagged = set(card["file_name"][
                        card["is_bottom_5pct"].astype(bool)].tolist())
                    fig["recall"] = len(flagged & planted) / len(planted)
                    print(f"[tools] {tag}: planted recall "
                          f"{fig['recall']:.4f} ({len(planted)} planted, "
                          f"{len(flagged)} flagged)")
                    check(fig["recall"] >= TOOLS_RECALL,
                          f"{tag}: planted recall {fig['recall']}")
                print(f"[tools] {tag}: score {score_s:.3f}s ({smi})")
                figures["scores"][tag] = fig

        # the k-means alone (the card's runs), each class's inertia against
        # the CPU's from the card's initial centres
        data = load_embedding_cache(synth_cache)
        scorer = MultiPrototypeScorer(data["embeddings"], data["labels"],
                                      data["metadata"], device=dev)
        t0 = time.perf_counter()
        scorer.compute_prototypes()
        figures["kmeans_s"] = sync_s(t0)
        worst = 0.0
        x = torch.from_numpy(data["embeddings"])
        for label, run in scorer.kmeans_runs.items():
            cpu_run = kmeans(x[torch.from_numpy(data["labels"] == label)],
                             run.centers.shape[0], init=run.init.cpu())
            worst = max(worst, abs(cpu_run.inertia - run.inertia)
                        / run.inertia)
        figures["kmeans_inertia_rel"] = worst
        print(f"[tools] k-means over {len(scorer.kmeans_runs)} classes "
              f"({TOOLS_CACHE[0]} rows, 10 runs a class): "
              f"{figures['kmeans_s']:.3f}s on the card ({smi}); inertia vs "
              f"the CPU from the same initial centres, max rel {worst:.3e}")
        check(worst <= TOOLS_INERTIA_REL, "k-means inertia differs from the "
              "CPU's")
        del scorer

        # ---- (4) the projection
        t0 = time.perf_counter()
        info = feat_vis.main(["--cache_dir", str(synth_cache), "--method",
                              "tsne", "--pca_dim", "50", "--out_dir",
                              str(Path(tmp) / "vis"), "--device", dev])
        wall = time.perf_counter() - t0
        res = info["tsne"]
        coords = np.load(info["coords"])
        labels = torch.from_numpy(data["labels"].astype(np.int64)).to(dev)
        agree = tsne.knn_label_agreement(res.embedding, labels)
        agree0 = tsne.knn_label_agreement(res.init, labels)
        figures["tsne"] = dict(
            n=TOOLS_CACHE[0], wall_s=wall, pca_s=info["pca_s"],
            seconds=res.seconds, n_iter=res.n_iter,
            kl=res.kl_divergence, kl_after_exaggeration=
            res.kl_after_exaggeration, kl_exaggerated=res.kl_exaggerated,
            knn10_agreement=agree, knn10_agreement_pca_init=agree0)
        print(f"[tools] feat_vis t-SNE of {TOOLS_CACHE[0]} points (PCA 50) "
              f"in {wall:.2f}s ({smi}): PCA {info['pca_s']:.3f}s, P "
              f"{res.seconds['affinities']:.3f}s, init "
              f"{res.seconds['pca_init']:.3f}s, {res.n_iter + 1} iterations "
              f"{res.seconds['iterations']:.2f}s; KL "
              f"{res.kl_exaggerated:.4f} (x12 P) / "
              f"{res.kl_after_exaggeration:.4f} after exaggeration, final "
              f"{res.kl_divergence:.4f}; 10-NN label agreement {agree:.4f} "
              f"(PCA-2 init {agree0:.4f})")
        check(coords.shape == (TOOLS_CACHE[0], 2)
              and bool(np.isfinite(coords).all()), "t-SNE coordinates")
        check(res.kl_divergence < res.kl_after_exaggeration,
              "the final KL is not below the KL after exaggeration")
        check(agree >= agree0, "t-SNE's 10-NN label agreement is below the "
              "PCA-2 init's")
        check((Path(tmp) / "vis/vis_tsne.html").read_text().count("<circle")
              == TOOLS_CACHE[0], "the HTML does not hold a mark a point")

        draw = np.random.default_rng(SEED).choice(
            TOOLS_CACHE[0], TOOLS_TSNE_DRAW, replace=False)
        xs = torch.from_numpy(data["embeddings"][draw])
        dense = []
        for where in (dev, "cpu"):
            p = tsne.affinities(xs.to(where), 30.0)
            dense.append(torch.sparse_coo_tensor(
                torch.stack([p.rows, p.cols]).cpu(), p.values.cpu(),
                (TOOLS_TSNE_DRAW,) * 2, check_invariants=True).to_dense())
        p_err = float((dense[0] - dense[1]).abs().max())
        t0 = time.perf_counter()
        kl_card = tsne.tsne(xs.to(dev)).kl_divergence
        card_s = sync_s(t0)
        kl_cpu = tsne.tsne(xs).kl_divergence
        kl_rel = abs(kl_card - kl_cpu) / kl_cpu
        figures["tsne_check"] = dict(n=TOOLS_TSNE_DRAW, p_max_abs=p_err,
                                     kl_card=kl_card, kl_cpu=kl_cpu,
                                     kl_rel=kl_rel, card_s=card_s)
        print(f"[tools] t-SNE of {TOOLS_TSNE_DRAW} rows, card vs CPU: P "
              f"max|d| {p_err:.3e} (limit {TOOLS_P_TOL:g}); final KL "
              f"{kl_card:.5f} vs {kl_cpu:.5f}, rel {kl_rel:.3e} (limit "
              f"{TOOLS_KL_REL:g}); {card_s:.2f}s on the card")
        check(p_err <= TOOLS_P_TOL, "t-SNE P differs from the CPU's")
        check(kl_rel <= TOOLS_KL_REL, "t-SNE final KL differs from the CPU's")

        # ---- (5) Canny
        n, side = TOOLS_CANNY
        batch = np.stack([smoke_photo(side, side, SEED + 100 + i)
                          for i in range(n)])
        big = smoke_photo(*RUNNER_LARGE_JPEG, SEED)
        figures["canny"] = {}
        for tag, imgs in ((f"{n}x{side}^2", batch), ("12 MP", big)):
            cpu_t = torch.from_numpy(imgs)
            card_t = cpu_t.to(dev)
            for fn in (edges.canny_rgb, edges.edge_blend):
                ref = fn(cpu_t)
                got = fn(card_t)
                check(torch.equal(got.cpu(), ref), f"{fn.__name__} on {tag} "
                      "differs from the CPU's")
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fn(card_t)
                    times.append(1e3 * sync_s(t0))
                key = f"{fn.__name__} {tag}"
                figures["canny"][key] = dict(
                    ms=statistics.median(times),
                    edge_share=float((ref > 0).float().mean())
                    if fn is edges.canny_rgb else None)
                print(f"[tools] {key}: {statistics.median(times):.3f} ms a "
                      f"call (median of 5, host clock after a sync; "
                      f"{smi}), bit for bit with the CPU")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return figures


# ---------------------------------------------------------------------------
# A13: the parallel paths, on ranks started as subprocesses
# ---------------------------------------------------------------------------

# the ViT-B/16 default fine-tune step (6c's configuration) per path, each
# against the single-rank step on the same global batch and draws: loss
# relative |d| and gradient cosine within VIT_STEP_GATES["plain"] (the
# spread of one step's bf16 roundings; a parallel step differs from the
# single rank's only in where its sums are cut and in which order they add;
# the cosine, summed in fp64, must also not pass 1 + PAR_COS_OVER, which no
# true cosine does), and the parameters after the step: each element's
# update is Adam's first step on the path's own gradient, -lr g / (|g| +
# eps), within PAR_ADAM_TOL lr beyond the fp32 rounding of the parameter
# (2^-22 |p|; a wrong moment or a shard's update on another's parameter is
# off by up to 2 lr), and the update's sign agrees with the reference's on
# PAR_SIGN_MIN of the elements whose reference gradient is above
# PAR_SIGN_FLOOR of its largest (below that the sign is rounding noise, as
# the CPU tests found).  On an H100 (PERF.md) the paths disagreed on at
# most 3.8e-6 of those signs (TP; DP 1.8e-7, FSDP 3.6e-7, the pipeline
# 6e-8): the limit allows 1e-4, 26 times that; a gradient unrelated to the
# reference agrees on about half
PAR_GATE = VIT_STEP_GATES["plain"]
PAR_COS_OVER, PAR_ADAM_TOL = 1e-9, 1e-3
PAR_SIGN_MIN, PAR_SIGN_FLOOR = 0.9999, 1e-3
# A TP step cuts the text tower's sums too (A13b): in bf16 a reordering of
# them moves the random text tower's features by its own rounding, which
# the 100x logits carry to the whole step.  On an H100 the bf16 TP step of
# both towers read loss rel 9.063e-3, gradient cosine 0.999394 and sign
# agreement 0.99916 from the bf16 single rank (TP of the visual blocks
# alone, 2.3e-3 and 0.99997), and the fp32 single rank 4.619e-3, 0.999564
# and 0.99951 from it: bf16's own rounding.  So the TP arms are gated in
# fp32 by PAR_GATE, where it reads the shards' arithmetic, and the bf16 TP
# step by TP16_GATE (loss rel, cosine, sign agreement), each the geometric
# mean of that step's reading and the nearer of the faults tp16_faults
# plants, which must fail it: the text tower's MLP partials unsummed read
# 1.260e-1, 0.2238 and 0.5819, its attention not causal 2.815e-1, -0.1469
# and 0.4456 (1 - cosine and 1 - agreement for the last two; PERF.md §6)
TP16_GATE = (3.4e-2, 0.978, 0.981)
PAR_STAGES, PAR_MICRO, PAR_UNLOCKED_LAYERS = 2, 4, 10
PAR_EVAL_N, PAR_CACHE_N = 32, 40
# A13b's SO400M arms: full width, 9 of the 27 blocks a tower (the smoke's
# time limit; the DP step above keeps all 27)
PAR_SL_LAYERS = 9
# each A13b arm's drop in peak against its control (the same unread
# tower on both sides) must reach this share of reckon_gather_gib's
A13B_DROP_MIN = 0.5
PAR_TIMEOUTS = {"nccl1": 240, "pair": 720}


def _par_flat(tensors) -> "torch.Tensor":
    import torch

    return torch.cat([t.detach().float().reshape(-1) for t in tensors])


def _par_adam_err(grad, upd, before) -> float:
    """The largest departure of an update from Adam's first step on its
    gradient (-lr g / (|g| + 1e-8)), past the fp32 rounding of the
    parameter, in units of lr (host vectors, summed in fp64)."""
    g = grad.double()
    want = -PEFT_LR * g / (g.abs() + 1e-8)
    err = (upd.double() - want).abs() - 2.0 ** -22 * before.double().abs()
    return float(err.max().clamp_min(0.0)) / PEFT_LR


def _par_compare(tag, got, ref, line, gate: bool = True,
                 limits=(*PAR_GATE, PAR_SIGN_MIN)) -> dict:
    """(loss, grad, update, adam_err) of a path against the reference's:
    ``limits`` (loss rel, gradient cosine, update sign agreement; the
    cosine also at most 1 + PAR_COS_OVER, the update within PAR_ADAM_TOL
    of Adam's first step), checked with ``gate`` (else the figures alone);
    returns the figures and whether they pass (``passes``)."""
    import torch

    rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    # fp64 sums: over 85 M elements an fp32 cosine drifts past 1
    g, r = got["grad"].double(), ref["grad"].double()
    cos = (g @ r / (g.norm() * r.norm())).item()
    big = r.abs() > PAR_SIGN_FLOOR * r.abs().max()
    agree = (torch.sign(got["upd"][big]) == torch.sign(ref["upd"][big])
             ).double().mean().item()
    line(f"{tag} vs the single-rank step: loss {got['loss']:.6f} vs "
         f"{ref['loss']:.6f}, rel |d| {rel:.3e} (limit {limits[0]:g}); "
         f"gradient cosine {cos:.9f} (limits {limits[1]:g} to 1 + "
         f"{PAR_COS_OVER:g}); update sign agreement {agree:.6f} over "
         f"{int(big.sum())} elements (limit {limits[2]:g}); update vs "
         f"Adam's first step on its gradient {got['adam_err']:.3e} lr "
         f"(limit {PAR_ADAM_TOL:g})")
    step_ok = rel <= limits[0] and limits[1] <= cos <= 1 + PAR_COS_OVER
    params_ok = agree >= limits[2] and got["adam_err"] <= PAR_ADAM_TOL
    if gate:
        check(step_ok, f"{tag}: step gate")
        check(params_ok, f"{tag}: the parameters after the step")
    return dict(loss_rel=rel, grad_cos=cos, sign_agree=agree,
                adam_err=got["adam_err"], passes=step_ok and params_ok)


def tp16_faults(text_len: int) -> dict:
    """The faults planted in the bf16 TP step, TP16_GATE's witnesses:
    {name: (a context that plants it, whether the gate must fail it)}.
    The text tower's attention without its causal mask; the text tower's
    MLP partials left unsummed (each rank keeps its own); every
    row-parallel partial summed in fp16, which holds each bf16 partial of
    the step (a finer mantissa, the activations well inside its range) and
    so moves the step only as far as another order of the sums would: that
    one is printed, not failed.  ``text_len``: the text tower's sequence
    (its blocks' [B, S, W] inputs)."""
    import functools
    from unittest import mock

    from aihab_clip_tpu_torch.ops.attention import dot_product_attention
    from aihab_clip_tpu_torch.parallel import comm, tensor

    mlp, reduce = tensor._tp_mlp, comm.reduce_from_group

    def text_unsummed(m, h, mesh):
        if h.shape[-2] != text_len:
            return mlp(m, h, mesh)
        with mock.patch.object(comm, "reduce_from_group", lambda x, *_: x):
            return mlp(m, h, mesh)

    return {
        "the text tower's attention not causal": (lambda: mock.patch.object(
            tensor, "_block_attend", lambda att: functools.partial(
                dot_product_attention, causal=False)), True),
        "the text tower's MLP partials unsummed": (
            lambda: mock.patch.object(tensor, "_tp_mlp", text_unsummed),
            True),
        "every row-parallel partial summed in fp16": (
            lambda: mock.patch.object(
                comm, "reduce_from_group", lambda x, mesh, axis: reduce(
                    x.half(), mesh, axis).to(x.dtype)), False)}


def parallel_worker(workdir: str, mode: str) -> None:
    """One rank of the parallel phase (``python3 chip_smoke.py
    --parallel-worker <dir> <mode>`` under ``spawn_ranks``' environment):
    ``nccl1``, one NCCL rank (the collectives on the card, a 1-rank mesh's
    step); ``pair``, two ranks (DP, TP, FSDP, the pipeline, the DP eval,
    the sharded cache, each against the single rank; then A13b's arms at
    full width: ViT-B/16 LoRA and SO400M LoRA with scan + remat under
    FSDP, SO400M under TP (both SO400M arms at ``PAR_SL_LAYERS`` blocks a
    tower), ConvNeXt base_w and RN50 under FSDP, each with its peak beside
    its whole-gather control's).  Rank 0 writes
    ``<dir>/<mode>.json``; a failed gate raises, and the rank exits non-zero."""
    import os
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from aihab_clip_tpu_torch.cache import (cache_features_from_loader,
                                            feature_cache_dir,
                                            read_preprojection_cache)
    from aihab_clip_tpu_torch.data import SplitView
    from aihab_clip_tpu_torch.models import build_text_head, load
    from aihab_clip_tpu_torch.ops import block_kernel as bk
    from aihab_clip_tpu_torch.parallel import comm
    from aihab_clip_tpu_torch.parallel.distributed import (
        initialize_distributed, local_device, process_shard_indices)
    from aihab_clip_tpu_torch.parallel.mesh import make_mesh
    from aihab_clip_tpu_torch.parallel.pipeline import make_pipeline_mesh
    from aihab_clip_tpu_torch.templates import gen_prompts
    from aihab_clip_tpu_torch.tools.dryrun_multichip import (_parallel_step,
                                                             parallel_step)
    from aihab_clip_tpu_torch.train.evaluate import evaluate
    from aihab_clip_tpu_torch.train.peft import (
        PEFTConfig, _pack_prefix, build_lock_mask, make_train_step,
        step_generator)
    from aihab_clip_tpu_torch.train.pipeline_peft import (
        init_pipeline_trainable, make_pipeline_train_step,
        stacked_layer_mask)

    spec = json.loads((Path(workdir) / "spec.json").read_text())
    smi, backend = spec["smi"], spec["backend"]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = local_device(spec["device"])
    on_card = dev.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    unlocked, n_prefix = spec["unlocked"], spec["prefix"]
    if mode == "nccl1":
        kw = {}
        if on_card:
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(
            "nccl" if on_card else "gloo",
            init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            rank=0, world_size=1, **kw)
    else:
        initialize_distributed(device=dev, backend=backend)
    rank, world = dist.get_rank(), dist.get_world_size()
    lines = []

    def line(msg):
        text = (f"[parallel] {msg} ({dist.get_backend()}, world {world}, "
                f"rank {rank}; {smi})")
        lines.append(text)
        print(text, flush=True)

    from aihab_clip_tpu_torch.models import CLIPConfig

    pristine = load(spec["model"], dtype=dtype, device=dev, seed=SEED,
                    random_cfg=(CLIPConfig(**spec["config"])
                                if spec.get("config") else None)).model
    mcfg = pristine.config
    layers = mcfg.vision_layers
    prompts, tpc = gen_prompts(use_hierarchy=True, use_descriptive=True)
    head = {k: v.clone() if torch.is_tensor(v) else v for k, v in
            build_text_head(pristine, prompts, 20, tpc).items()}
    tokens = head["prompt_tokens"]
    decode = spec["decode"]
    ds = synthetic_dataset(np.random.default_rng(SEED + 3), PEFT_B, decode)
    batch = next(SplitView(ds, np.arange(PEFT_B), PEFT_B).batches())
    imgs, labs, valid = (torch.from_numpy(a).to(dev) for a in (
        batch.images, batch.labels, batch.valid))
    cfg = PEFTConfig(resolution=mcfg.image_resolution, num_classes=20,
                     lr=PEFT_LR, epochs=1, crop_mode="random", rotation=True,
                     tune_text=True, num_templates=tpc, compute_dtype=dtype,
                     fused_prefix=0)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(step, args, warm=1, n=3):
        """ms of n steps after warm (CUDA events; the host clock on the
        CPU rehearsal)."""
        times = []
        for i in range(warm + n):
            if on_card:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
            t0 = time.perf_counter()
            step(*args(i))
            if on_card:
                e1.record()
            sync()
            if i >= warm:
                times.append(e0.elapsed_time(e1) if on_card
                             else 1e3 * (time.perf_counter() - t0))
        return times

    def peak_gib():
        return (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else 0.0)

    def reset_peak():
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peft_path(tag, mesh=None, fsdp=False, prefix=0, control=False,
                  fp32=False, warm=1, n=3):
        """One step (``parallel_step``: loss, whole gradient, whole update,
        K1 launches; the vectors kept on the host), then the step's ms and
        the rank's peak memory over the timed steps (the model, its
        optimizer state and the steps' working set); with ``control``,
        also the peak of the same step with every weight gathered whole
        (``ctl_peak_gib``); ``fp32``: both towers compute in fp32; ``warm``
        and ``n``: the steps before and in the timing."""
        def masked():
            m = in_dtype(copy.deepcopy(pristine), fp32)
            build_lock_mask(m, layers, mcfg.transformer_layers,
                            unlocked_groups=unlocked, tune_text=True,
                            unlocked_text_layers=1)
            return m

        model = masked()
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        c = dataclasses.replace(cfg, fused_prefix=prefix, compute_dtype=(
            torch.float32 if fp32 else cfg.compute_dtype))
        pprefix = _pack_prefix(model, c) if prefix else None
        bk.reset_launch_counts()
        res = parallel_step(model, c, None, tokens, (imgs, labs, valid),
                            step_generator(SEED, 0, 0), mesh, fsdp,
                            pprefix=pprefix)
        sync()
        k1 = bk.launch_counts()["full_block_fused"]
        with torch.no_grad():
            before = _par_flat(pristine.get_parameter(n) for n in names).cpu()
            grad = _par_flat(res["grads"][n] for n in names).cpu()
            upd = _par_flat(res["params"][n] for n in names).cpu() - before
        step, loss = res["step"], res["loss"]
        del res
        adam_err = _par_adam_err(grad, upd, before)
        del before
        reset_peak()
        times = timed(step, lambda i: (imgs, labs, valid,
                                       step_generator(SEED, 1, i), PEFT_LR,
                                       pprefix), warm=warm, n=n)
        peak = peak_gib()
        del model, step
        ctl, ctl_ms = whole_gather_peak(
            masked, c, None, tokens, mesh, fsdp, None, pprefix) \
            if control else (None, None)
        line(f"{tag}: step median {statistics.median(times):.3f} ms over "
             f"{len(times)} ({', '.join(f'{t:.2f}' for t in times)}); peak "
             f"{peak:.2f} GiB this rank"
             + (f" (every weight gathered whole: {ctl:.2f} GiB, "
                f"{ctl_ms:.3f} ms)" if control else "")
             + f"; {k1} K1 in the first step")
        return dict(loss=loss, grad=grad, upd=upd, adam_err=adam_err, k1=k1,
                    ms=statistics.median(times), ms_all=times, peak_gib=peak,
                    ctl_peak_gib=ctl, ctl_ms=ctl_ms)

    def in_dtype(model, fp32):
        """``model`` computing in fp32 when ``fp32`` (its towers' compute
        dtype; the parameters are fp32 either way)."""
        if fp32:
            model.visual.dtype = model.text.dtype = torch.float32
        return model

    def whole_gather_peak(make, c, tw, toks, mesh, fsdp, adapters,
                          pprefix=None, lora_rank=0):
        """The rank's peak and ms over one step with every weight gathered
        whole for the step (``peft._make_train_step``'s control of the
        per-block gather and of the tensor-parallel shards), after a first
        one."""
        model = make()
        if lora_rank:
            model.requires_grad_(False)
            adapters = lora_adapters(model, lora_rank)
        res = _parallel_step(model, c, tw, toks, (imgs, labs, valid),
                             step_generator(SEED, 0, 0), mesh, fsdp,
                             adapters, pprefix, control=True)
        step = res["step"]
        del res
        reset_peak()
        ms = timed(step, lambda i: (imgs, labs, valid,
                                    step_generator(SEED, 1, i), PEFT_LR,
                                    pprefix), warm=0, n=1)[0]
        peak = peak_gib()
        del model, step, adapters
        return peak, ms

    def lora_adapters(model, rank):
        """The runner's LoRA init (attention weights of the visual tower,
        its seed), B drawn at N(0, 1e-3) so A's first gradient is not 0."""
        from aihab_clip_tpu_torch.train.lora import lora_init

        adapters = lora_init(model, rank, torch.Generator().manual_seed(
            SEED + 7919))
        with torch.no_grad():
            for ab in adapters.values():
                ab["b"].copy_(torch.randn(ab["b"].shape, generator=(
                    torch.Generator().manual_seed(SEED + 8))) * 1e-3)
        return adapters

    def a13b_arm(tag, host_model, c, tw, toks, mesh, fsdp, *, unlocked=0,
                 lora_rank=0, fp32=False):
        """A per-block FSDP or tensor-parallel step of a tower at full
        width (the model drawn once on the host, ``host_model``; each
        variant a fresh copy on the card) against the single rank's step
        on rank 0 (the ``PAR_*`` gates), its ms over 2 timed steps after
        that compared step (the warm-up), the rank's peak beside the
        whole-gather control's."""
        from aihab_clip_tpu_torch.train.peft import build_lock_mask

        mc = host_model.config
        text_layers = getattr(mc, "transformer_layers", None) or getattr(
            mc, "text_layers")

        if fp32:
            c = dataclasses.replace(c, compute_dtype=torch.float32)

        def fresh():
            model = in_dtype(copy.deepcopy(host_model).to(dev), fp32)
            if lora_rank:
                model.requires_grad_(False)
                adapters = lora_adapters(model, lora_rank)
                names = [f"{n}.{k}" for n, ab in adapters.items()
                         for k in ("a", "b")]
                vals = {f"{n}.{k}": ab[k] for n, ab in adapters.items()
                        for k in ("a", "b")}
            else:
                mask = build_lock_mask(model, mc.vision_layers, text_layers,
                                       unlocked_groups=unlocked,
                                       tune_text=c.tune_text,
                                       unlocked_text_layers=1)
                names = [n for n, p in model.named_parameters() if mask[n]]
                vals = dict(model.named_parameters())
                adapters = None
            with torch.no_grad():
                before = _par_flat(vals[n] for n in names).cpu()
            return model, adapters, names, before

        def first(mesh_):
            model, adapters, names, before = fresh()
            res = parallel_step(model, c, tw, toks, (imgs, labs, valid),
                                step_generator(SEED, 0, 0), mesh_,
                                fsdp and mesh_ is not None, adapters)
            sync()
            with torch.no_grad():
                grad = _par_flat(res["grads"][n] for n in names).cpu()
                upd = _par_flat(res["params"][n] for n in names).cpu() \
                    - before
            got = dict(loss=res["loss"], grad=grad, upd=upd,
                       adam_err=_par_adam_err(grad, upd, before))
            return got, res["step"], model, adapters

        ref = None
        if rank == 0:
            ref, step, model, adapters = first(None)
            del step, model, adapters
            torch.cuda.empty_cache()
        got, step, model, adapters = first(mesh)
        reset_peak()
        times = timed(step, lambda i: (imgs, labs, valid,
                                       step_generator(SEED, 1, i), PEFT_LR),
                      warm=0, n=2)
        peak = peak_gib()
        del step, model, adapters
        torch.cuda.empty_cache()
        ctl, ctl_ms = whole_gather_peak(
            lambda: copy.deepcopy(host_model).to(dev), c, tw, toks, mesh,
            fsdp, None, lora_rank=lora_rank) if lora_rank \
            else whole_gather_peak(lambda: fresh()[0], c, tw, toks, mesh,
                                   fsdp, None)
        torch.cuda.empty_cache()
        peaks = comm.all_gather_cat(torch.tensor(
            [peak, ctl], device=dev), dp_mesh, "data", 0).view(world, 2)
        reckoned = reckon_gather_gib(mc, tp=not fsdp, text=c.tune_text)
        want = reckoned["drop" if fsdp else "tp_cut"]
        drops = peaks[:, 1] - peaks[:, 0]
        line(f"{tag}: step median {statistics.median(times):.3f} ms over "
             f"{len(times)} ({', '.join(f'{t:.2f}' for t in times)}); peak "
             f"per rank {[round(p, 3) for p in peaks[:, 0].tolist()]} GiB; "
             f"every weight gathered whole "
             f"{[round(p, 3) for p in peaks[:, 1].tolist()]} GiB, "
             f"{ctl_ms:.3f} ms a step; drop per rank "
             f"{[round(d, 3) for d in drops.tolist()]} GiB, reckoned "
             f"{want:.3f} GiB (limit {A13B_DROP_MIN:g} of it)")
        check(not on_card or bool((peaks[:, 0] < peaks[:, 1]).all()),
              f"{tag}: a rank's peak is not below its whole-gather "
              f"control's")
        check(not on_card or bool((drops >= A13B_DROP_MIN * want).all()),
              f"{tag}: a rank's drop is below {A13B_DROP_MIN:g} of the "
              f"reckoned {want:.3f} GiB")
        fig = dict(ms=statistics.median(times), ms_all=times,
                   peak_gib=peaks[:, 0].tolist(),
                   ctl_peak_gib=peaks[:, 1].tolist(), ctl_ms=ctl_ms,
                   drop_gib=drops.tolist(), reckoned_gib=reckoned)
        if rank == 0:
            fig.update(_par_compare(tag, got, ref, line))
        return fig

    def so400m_dp(mesh, host_model):
        """The SO400M default step under DP (its prefix per rank): K5 and
        K4 on the 17 frozen blocks, K6 forward and backward on the 10
        trainable ones, counted per rank; its time and peak; and the
        tower's text head."""
        from aihab_clip_tpu_torch.ops import attention as att
        from aihab_clip_tpu_torch.train.peft import peft_fused_prefix_len

        sm = copy.deepcopy(host_model).to(dev)
        scfg = sm.config
        shead = build_text_head(sm, prompts, 20, tpc,
                                context_length=scfg.context_length)
        stokens = shead["prompt_tokens"]
        build_lock_mask(sm, scfg.vision_layers, scfg.text_layers,
                        unlocked_groups=PEFT_UNLOCKED, tune_text=True,
                        unlocked_text_layers=1)
        n_pre = peft_fused_prefix_len(scfg, PEFT_UNLOCKED, dev, mesh=mesh,
                                      batch_size=PEFT_B)
        c = dataclasses.replace(cfg, resolution=scfg.image_resolution,
                                fused_prefix=n_pre)
        pp = _pack_prefix(sm, c)
        _, step = make_train_step(sm, c, None, stokens, mesh=mesh)
        bk.reset_launch_counts()
        att.reset_launch_counts()
        sm_m = step(imgs, labs, valid, step_generator(SEED, 0, 0), PEFT_LR,
                    pp)
        sync()
        got = {**bk.launch_counts(), **att.launch_counts()}
        got = {k: got[k] for k in ("attn_block_split", "mlp_block_split",
                                   "fused_attention_fwd",
                                   "fused_attention_bwd")}
        n_suf = scfg.vision_layers - PEFT_PREFIX
        check(n_pre == PEFT_PREFIX and got == {
            "attn_block_split": PEFT_PREFIX, "mlp_block_split": PEFT_PREFIX,
            "fused_attention_fwd": n_suf, "fused_attention_bwd": n_suf},
            f"SO400M DP launches per rank {got}")
        reset_peak()
        times = timed(step, lambda i: (imgs, labs, valid,
                                       step_generator(SEED, 1, i), PEFT_LR,
                                       pp), n=2)
        peak = peak_gib()
        line(f"SO400M DP 2 step (prefix {n_pre} per rank): launches this "
             f"rank {got}; loss {float(sm_m['loss']):.6f}; step median "
             f"{statistics.median(times):.3f} ms ({', '.join(f'{t:.2f}' for t in times)}); "
             f"peak {peak:.2f} GiB")
        del sm, step, pp
        torch.cuda.empty_cache()
        return dict(launches=got, ms=statistics.median(times),
                    ms_all=times, peak_gib=peak, loss=float(sm_m["loss"])), {
            k: v.clone() if torch.is_tensor(v) else v
            for k, v in shead.items()}

    out = {"backend": dist.get_backend(), "world": world, "rank": rank}
    if mode == "nccl1":
        x = torch.arange(8, dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        dist.broadcast(x, 0)
        g = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(g, x)
        r = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(r, x)
        dist.barrier()
        check(torch.equal(g, x) and torch.equal(r, x), "NCCL collectives")
        line("NCCL init, all_reduce, broadcast, all_gather, "
             "reduce_scatter and barrier on the card")
        ref = peft_path("single-rank step (K1 prefix)", prefix=n_prefix)
        got = peft_path("1-rank mesh step (K1 prefix)",
                        make_mesh(device=dev), prefix=n_prefix)
        out["mesh1"] = _par_compare("1-rank mesh step", got, ref, line)
        out["mesh1"]["bitwise"] = bool(torch.equal(got["grad"], ref["grad"])
                                       and got["loss"] == ref["loss"])
        out["ms"] = {"single": ref["ms"], "mesh1": got["ms"]}
    else:
        dp_mesh = make_mesh(device=dev)
        tp_mesh = make_mesh(model_parallel=2, device=dev)
        ref = canon = canon32 = None
        if rank == 0:
            ref = peft_path("single-rank step (K1 prefix)", prefix=n_prefix)
            canon = peft_path("single-rank step (canonical, no prefix)")
            canon32 = peft_path("single-rank step (canonical, fp32)",
                                fp32=True)
        dp = peft_path("DP 2 (K1 prefix per rank)", dp_mesh, prefix=n_prefix)
        check(dp["k1"] == (n_prefix if on_card else 0),
              f"DP: {dp['k1']} K1 per rank")
        # TP gated in fp32 by PAR_GATE, in bf16 by TP16_GATE, which must
        # fail each planted fault it is required to
        tp = peft_path("TP 2 (Megatron halves, both towers; fp32)", tp_mesh,
                       control=True, fp32=True)
        tp16 = peft_path("TP 2 (bf16)", tp_mesh, warm=0, n=1)
        planted = tp16_faults(mcfg.context_length)
        faults = {}
        for name, (plant, _) in planted.items():
            with plant():
                faults[name] = peft_path(f"TP 2 (bf16) with {name}", tp_mesh,
                                         warm=0, n=1)
        check(tp["k1"] == 0 and tp16["k1"] == 0, "TP launched K1")
        fsdp = peft_path("FSDP 2 (no prefix)", dp_mesh, fsdp=True,
                         control=True)
        peaks = comm.all_gather_cat(torch.tensor(
            [dp["peak_gib"], tp["peak_gib"], fsdp["peak_gib"],
             tp["ctl_peak_gib"], fsdp["ctl_peak_gib"]], device=dev),
            dp_mesh, "data", 0).view(world, 5).tolist()
        for k, (i, j) in (("TP", (1, 3)), ("FSDP", (2, 4))):
            check(not on_card or all(p[i] < p[j] for p in peaks),
                  f"ViT-B/16 {k} 2: a rank's peak is not below its "
                  f"whole-gather control's")
        k1s = comm.all_gather_cat(torch.tensor([float(dp["k1"])], device=dev),
                                  dp_mesh, "data", 0).tolist()
        if rank == 0:
            out["dp"] = _par_compare("DP 2", dp, ref, line)
            out["tp"] = _par_compare("TP 2 (fp32)", tp, canon32, line)
            out["bf16_own"] = _par_compare(
                "single-rank step in fp32 (bf16's own rounding; ungated)",
                canon32, canon, line, gate=False)
            out["tp_bf16"] = _par_compare("TP 2 (bf16)", tp16, canon, line,
                                          limits=TP16_GATE)
            out["tp_bf16_faults"] = {}
            for name, (_, caught) in planted.items():
                out["tp_bf16_faults"][name] = got = _par_compare(
                    f"TP 2 (bf16) with {name} ("
                    + ("must fail TP16_GATE" if caught else "printed") + ")",
                    faults[name], canon, line, gate=False, limits=TP16_GATE)
                check(not (caught and got["passes"]),
                      f"TP16_GATE passed a planted fault: {name}")
            out["fsdp"] = _par_compare("FSDP 2", fsdp, canon, line)
            out["fsdp_vs_dp"] = _par_compare("FSDP 2 (against DP 2)", fsdp,
                                             dp, line)
            out["ms"] = {k: v["ms"] for k, v in (
                ("single", ref), ("single_canonical", canon),
                ("single_fp32", canon32), ("dp", dp), ("tp", tp),
                ("tp_bf16", tp16), ("fsdp", fsdp))}
            out["ms"].update(tp_whole=tp["ctl_ms"], fsdp_whole=fsdp["ctl_ms"])
            out["ms_all"] = {k: v["ms_all"] for k, v in (
                ("single", ref), ("dp", dp), ("tp", tp), ("fsdp", fsdp))}
            out["peak_gib"] = {"dp": [p[0] for p in peaks],
                               "tp": [p[1] for p in peaks],
                               "fsdp": [p[2] for p in peaks],
                               "tp_whole": [p[3] for p in peaks],
                               "fsdp_whole": [p[4] for p in peaks],
                               "single": ref["peak_gib"]}
            out["k1_per_dp_rank"] = k1s
            line(f"per-rank peak memory GiB: DP {out['peak_gib']['dp']}, TP "
                 f"{out['peak_gib']['tp']} (whole gather "
                 f"{out['peak_gib']['tp_whole']}), FSDP "
                 f"{out['peak_gib']['fsdp']} (whole gather "
                 f"{out['peak_gib']['fsdp_whole']}) (single rank "
                 f"{ref['peak_gib']:.2f}); K1 per DP rank per step {k1s}")
        del ref, canon, canon32, dp, tp, tp16, faults, fsdp

        # the pipeline: 2 stages x 4 microbatches against the unpipelined
        # canonical step (every rank holds the reference for its stage)
        pcfg = dataclasses.replace(cfg, tune_text=False)
        tw = head["text_weights"]
        model = copy.deepcopy(pristine)
        build_lock_mask(model, layers, mcfg.transformer_layers,
                        unlocked_groups=PAR_UNLOCKED_LAYERS + 1)
        _, rstep = make_train_step(model, pcfg, tw, None)
        rm = rstep(imgs, labs, valid, step_generator(SEED, 0, 0), PEFT_LR)
        pmesh = make_pipeline_mesh(PAR_STAGES, device=dev)
        stage, per = pmesh.coords["stage"], layers // PAR_STAGES
        pmodel = copy.deepcopy(pristine)
        trainable = init_pipeline_trainable(pmodel, mcfg, pmesh)
        before = {k: v.detach().clone()
                  for k, v in trainable["blocks"].items()}
        _, pstep = make_pipeline_train_step(
            pmodel, pcfg, tw, None, pmesh, num_microbatches=PAR_MICRO,
            unlocked_layers=PAR_UNLOCKED_LAYERS, trainable=trainable)
        comm.staged.clear()
        pm = pstep(imgs, labs, valid, step_generator(SEED, 0, 0), PEFT_LR)
        sync()
        mask = stacked_layer_mask(layers, PAR_STAGES,
                                  PAR_UNLOCKED_LAYERS)[stage]
        blocks = model.visual.transformer.resblocks
        keys = list(trainable["blocks"])
        live = [i for i in range(per) if mask[i]]
        got = dict(loss=float(pm["loss"]),
                   grad=_par_flat(trainable["blocks"][k].grad[i]
                                  for i in live for k in keys).cpu(),
                   upd=_par_flat(trainable["blocks"][k][i] - before[k][i]
                                 for i in live for k in keys).cpu())
        got["adam_err"] = _par_adam_err(got["grad"], got["upd"], _par_flat(
            before[k][i] for i in live for k in keys).cpu())
        refp = dict(loss=float(rm["loss"]),
                    grad=_par_flat(blocks[stage * per + i].get_parameter(
                        k).grad for i in live for k in keys).cpu(),
                    upd=_par_flat(
                        blocks[stage * per + i].get_parameter(k)
                        - pristine.visual.transformer.resblocks[
                            stage * per + i].get_parameter(k)
                        for i in live for k in keys).cpu())
        locked_same = all(torch.equal(trainable["blocks"][k][i],
                                      before[k][i])
                          for i in range(per) if not mask[i] for k in keys)
        check(locked_same, "pipeline: a locked layer moved")
        staged = dict(comm.staged)
        del model, rstep, before
        reset_peak()
        times = timed(pstep, lambda i: (imgs, labs, valid,
                                        step_generator(SEED, 1, i), PEFT_LR))
        ppeak = peak_gib()
        line(f"pipeline {PAR_STAGES} stages x {PAR_MICRO} microbatches, stage "
             f"{stage} ({len(live)} of {per} layers trainable): step median "
             f"{statistics.median(times):.3f} ms ({', '.join(f'{t:.2f}' for t in times)}); "
             f"peak {ppeak:.2f} GiB; locked layers bit-identical; host-staged "
             f"ops in one step {staged}")
        pipe = _par_compare(f"pipeline stage {stage}", got, refp, line)
        flags = comm.all_gather_cat(torch.tensor(
            [pipe["loss_rel"], pipe["grad_cos"], pipe["sign_agree"],
             statistics.median(times), ppeak], device=dev), dp_mesh, "data",
            0).view(world, 5).tolist()
        del pmodel, trainable, pstep

        # the DP eval of 2 batches: every rank's confusion matrix is the
        # single rank's
        eds = synthetic_dataset(np.random.default_rng(SEED + 4), PAR_EVAL_N,
                                decode)
        eview = SplitView(eds, np.arange(PAR_EVAL_N), PEFT_B)
        emodel = copy.deepcopy(pristine)
        with torch.no_grad():
            bk.reset_launch_counts()
            t0 = time.perf_counter()
            got_e = evaluate(emodel, eview, head["text_weights"],
                             mcfg.image_resolution, 20, compute_dtype=dtype,
                             return_confusion_matrix=True, mesh=dp_mesh)
            sync()
            eval_s = time.perf_counter() - t0
            ek1 = bk.launch_counts()["full_block_fused"]
            ref_e = (evaluate(emodel, eview, head["text_weights"],
                              mcfg.image_resolution, 20, compute_dtype=dtype,
                              return_confusion_matrix=True)
                     if rank == 0 else None)
        del emodel

        # the sharded cache: every rank writes its shard; rank 0 reads the
        # merged set against its own unsharded write
        cds = synthetic_dataset(np.random.default_rng(SEED + 5), PAR_CACHE_N,
                                decode)
        cview = SplitView(cds, np.arange(PAR_CACHE_N), PEFT_B)
        ccfg = {"dataset": "par", "seed": 1, "shots": 0, "aug_views": 2,
                "aug_impl": "fast", "backbone": "ViT-B/16",
                "clip_backend": "openai", "root_path": str(Path(workdir) /
                                                           "sharded"),
                "data": {"preprocessing": {"augmentations": {
                    "bottom_crop": False, "random_crop": False,
                    "flip": False, "rotation": False}}}}
        t0 = time.perf_counter()
        cache_features_from_loader(ccfg, pristine, cview,
                                   mcfg.image_resolution,
                                   {"train_size": PAR_CACHE_N},
                                   compute_dtype=dtype)
        sync()
        cache_s = time.perf_counter() - t0
        dist.barrier()
        if rank == 0:
            check(np.array_equal(got_e["cm"], ref_e["cm"]),
                  "DP eval confusion matrix")
            line(f"DP eval of {PAR_EVAL_N} images in {PEFT_B}-image batches: "
                 f"confusion matrix equal to the single rank's (top1 "
                 f"{got_e['top1']:.4f}, loss {got_e['loss']:.6f} vs "
                 f"{ref_e['loss']:.6f}); {ek1} K1 this rank; {eval_s:.3f} s")
            views, labels = read_preprojection_cache(
                feature_cache_dir(ccfg), 2, mmap=False)
            ucfg = dict(ccfg, root_path=str(Path(workdir) / "unsharded"))
            cache_features_from_loader(ucfg, pristine, cview,
                                       mcfg.image_resolution,
                                       {"train_size": PAR_CACHE_N},
                                       compute_dtype=dtype, shard_count=1)
            uviews, ulabels = read_preprojection_cache(
                feature_cache_dir(ucfg), 2, mmap=False)
            order = np.concatenate([process_shard_indices(
                PAR_CACHE_N, seed=1, process_index=k, process_count=world)
                for k in range(world)])
            same = np.array_equal(labels, ulabels[order]) and all(
                np.array_equal(a, b[order]) for a, b in zip(views, uviews))
            check(same, "the merged sharded cache vs the unsharded write")
            line(f"sharded cache, {PAR_CACHE_N} images x 2 views in {world} "
                 f"shards ({cache_s:.3f} s this rank): the merged read equals "
                 f"the unsharded write bit for bit")
            out["pipeline"] = {"per_stage": flags, "staged_ops": staged,
                               "locked_bit_identical": locked_same}
            out["ms"]["pipeline"] = [f[3] for f in flags]
            out["peak_gib"]["pipeline"] = [f[4] for f in flags]
            out["eval"] = {"cm_equal": True, "k1_rank0": ek1,
                           "seconds": eval_s}
            out["cache"] = {"bit_for_bit": True, "seconds_rank0": cache_s}
        del pristine
        torch.cuda.empty_cache()
        # the SigLIP tower of the DP step and of the A13b arms (SO400M;
        # a CPU rehearsal names a small one, or None)
        sl_name = spec.get("a13b_siglip", SL_MODEL)
        sl_host = shead = None
        if spec.get("so400m", True) or sl_name:
            sl_host = load(sl_name or SL_MODEL, dtype=dtype, device="cpu",
                           seed=SEED).model
        if spec.get("so400m", True):
            out["so400m_dp"], shead = so400m_dp(dp_mesh, sl_host)
        elif sl_name:
            shead = {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in build_text_head(
                         copy.deepcopy(sl_host).to(dev), prompts, 20, tpc,
                         context_length=sl_host.config.context_length)
                     .items()}
        if spec.get("a13b", True):
            # A13b: every weight read as JAX's GSPMD cuts it, at full
            # width: FSDP per block (LoRA, the scanned remat'd encode,
            # ConvNeXt, RN) and TP over both towers and the MAP head
            a13b = {}
            host = load(spec["model"], dtype=dtype, device="cpu", seed=SEED,
                        random_cfg=(CLIPConfig(**spec["config"])
                                    if spec.get("config") else None)).model
            a13b["vit_lora_fsdp"] = a13b_arm(
                f"{spec['model']} LoRA r8 FSDP 2 (per block)", host,
                dataclasses.replace(cfg, lora_rank=8, tune_text=False),
                head["text_weights"], None, dp_mesh, True, lora_rank=8)
            del host
            if sl_name:
                cut = sl_host.config
                if cut.vision_layers > PAR_SL_LAYERS:
                    del sl_host
                    cut = dataclasses.replace(cut, vision_layers=PAR_SL_LAYERS,
                                              text_layers=PAR_SL_LAYERS)
                    sl_host = load(sl_name, dtype=dtype, device="cpu",
                                   seed=SEED, random_cfg=cut).model
                sres = cut.image_resolution
                a13b["so400m_lora_fsdp"] = a13b_arm(
                    f"{sl_name[7:]} ({cut.vision_layers} + {cut.text_layers} "
                    "blocks) LoRA r8 scan + remat FSDP 2 (per block)",
                    sl_host, dataclasses.replace(
                        cfg, resolution=sres, lora_rank=8, tune_text=False,
                        scan_blocks=True, scan_remat=True),
                    shead["text_weights"], None, dp_mesh, True, lora_rank=8)
                a13b["so400m_tp"] = a13b_arm(
                    f"{sl_name[7:]} ({cut.vision_layers} + {cut.text_layers} "
                    "blocks) TP 2 (both towers and the MAP head as shards; "
                    "tune_text; fp32)", sl_host,
                    dataclasses.replace(cfg, resolution=sres),
                    None, shead["prompt_tokens"], tp_mesh, False,
                    unlocked=unlocked, fp32=True)
            del sl_host
            for tag, name, arm_unlocked in spec.get("a13b_towers", (
                    ("convnext_fsdp", "random:convnext_base_w", unlocked),
                    ("rn50_fsdp", "random:RN50", RN_PEFT_UNLOCKED))):
                host = load(name, dtype=dtype, device="cpu", seed=SEED).model
                if not host.config.is_vit and host.config.tower == "rn":
                    from aihab_clip_tpu_torch.tools.rn_gains import (
                        calibrate_bn_, seeded_photos)

                    host = host.to(dev)
                    calibrate_bn_(host, torch.from_numpy(seeded_photos(
                        16, host.config.image_resolution, SEED + 11)).to(dev),
                        SEED + 11)
                    host = host.cpu()
                a13b[tag] = a13b_arm(
                    f"{name[7:]} FSDP 2 (per block)", host,
                    dataclasses.replace(
                        cfg, resolution=host.config.image_resolution),
                    None, tokens, dp_mesh, True, unlocked=arm_unlocked)
                del host
            if rank == 0:
                out["a13b"] = a13b
    out["lines"] = lines
    out["staged"] = dict(comm.staged)
    if rank == 0:
        (Path(workdir) / f"{mode}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def parallel_path(smi: str, dev: str = "cuda", **spec) -> dict:
    """The parallel phase: one NCCL rank, then two ranks, each launched as
    subprocesses with a hard timeout (a rank that fails or hangs fails the
    phase).  With two or more cards the pair is one NCCL rank a card; with
    one card both ranks share it over gloo (NCCL refuses two ranks on one
    device), so the pair measures correctness and per-rank memory, not
    scaling.  ``dev="cpu"`` (with a small ``model``, ``unlocked``,
    ``prefix`` 0 and ``decode``) rehearses the phase on gloo CPU ranks."""
    import tempfile
    from pathlib import Path

    import torch

    from aihab_clip_tpu_torch.parallel.distributed import spawn_ranks

    spec = dict(dict(model="random:ViT-B/16", unlocked=PEFT_UNLOCKED,
                     prefix=VIT_PEFT_PREFIX, decode=PEFT_DECODE), **spec)
    cards = torch.cuda.device_count() if dev == "cuda" else 0
    shared = cards < 2
    backend = "gloo" if shared else "nccl"
    figures = {"cards": cards, "pair_backend": backend,
               "pair_shares_one_card": shared}
    with tempfile.TemporaryDirectory(prefix="aihab_par_") as workdir:
        (Path(workdir) / "spec.json").write_text(json.dumps(
            dict(spec, smi=smi, backend=backend, device=dev)))
        for mode, n in (("nccl1", 1), ("pair", 2)):
            t0 = time.perf_counter()
            outs = spawn_ranks([__file__, "--parallel-worker", workdir, mode],
                               n, PAR_TIMEOUTS[mode],
                               one_device=mode == "nccl1" or shared)
            for r, text in enumerate(outs):
                for ln in text.splitlines():
                    if ln.startswith("[parallel]") and (r == 0 or "stage" in ln):
                        print(ln)
            figures[mode] = json.loads((Path(workdir) / f"{mode}.json")
                                       .read_text())
            figures[mode]["wall_s"] = time.perf_counter() - t0
            print(f"[parallel] {mode}: {n} rank(s) in "
                  f"{figures[mode]['wall_s']:.1f} s ({smi})")
    if shared:
        print(f"[parallel] the pair shared one card over gloo: its times and "
              f"memory read correctness and per-rank memory, not scaling "
              f"({smi})")
    return figures


if __name__ == "__main__":
    main()
