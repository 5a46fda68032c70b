"""W8A8 int8 kernels on Hopper, with their plain versions (counterpart of
``aihab_clip_tpu/ops/quant_matmul.py``).

  * ``quant_matmul_fused``      (K8)  [LN] -> row quantize -> int8 GEMM ->
                                      dequant + bias -> act [+ residual]
  * ``quant_matmul_fused_qout`` (K9)  LN -> row quantize -> int8 GEMM ->
                                      dequant + bias -> act -> requantize
  * ``quant_matmul_q8in``       (K10) int8 GEMM on quantized rows ->
                                      dequant + bias + residual
  * ``quant_attn_block_split``  (K13) LN -> row quantize -> int8 QKV over
                                      head groups -> bf16 MHA -> requantize
                                      per group -> int8 out-proj, the group
                                      partials summed in fp32 + b + x
  * ``quant_attn_block_fused``  (K12) K13 with one group: the whole
                                      attention row requantized
  * ``quant_mlp_block_fused``   (K11) LN -> quantize -> int8 c_fc -> act ->
                                      requantize the hidden row -> int8
                                      c_proj + b2 + x
  * ``quant_full_block_fused``  (K14) K12 with the mid-block residual y1 in
                                      fp32, then K11 over y1 with the hidden
                                      row requantized per chunk and
                                      out = (y1 + b2) + the chunk partials
  * ``quant_convnext_mlp_block`` (K15) K11 with ConvNeXt's quirks: LN eps
                                      1e-6 of the dwconv output y, gelu_poly,
                                      out = res + (part + b2) * gamma onto
                                      the block input

On the TPU each is one Pallas program per row tile (K13: per image and head
group) with its int8 weights resident in VMEM.  On the H100 each is a
composition of hand-written CUDA kernels (``csrc/quant_kernels.cu``, whose
header gives the design and the bound):

  * ``row_quant``  optional fp32 LN, then per row (or per head group of a
                   row) s = max(amax, 1e-12) * (1/127) and the int8 codes
  * ``int8_gemm``  int8 x int8 -> int32 on the tensor cores (TMA + wgmma),
                   dequant acc * (s_x * s_w) + bias, act, q-scale,
                   per-column gamma, residual; or with
                   a dequant per group of K, summed in group order onto
                   part_0 + bias + residual, or (residual-first) onto
                   residual + bias; or y = act(dequant + bias) requantized
                   in the same launch (``out_dtype=torch.int8``: codes and
                   row scales, per whole row or per hidden chunk)
  * ``attention``  (``ops/block_kernel.py``) the bf16 attention core over
                   the grouped qkv, q pre-scaled, fp32 output, on the flash
                   kernel: K13's with the 1/sum on the output rows, K12's
                   and K14's with P normalised before its bf16 cast

K8 = row_quant -> int8_gemm.  K9 = row_quant(LN) -> int8_gemm with the
quantized output: the requantize needs a whole row, which no GEMM tile
holds, so each block keeps its fp32 y tile in shared memory, folds the
tile's |y| into the row maxima in device memory by atomicMax, counts the
tile in its 128-row panel's counter, and quantizes the tile after its next
main loop, once the panel's count is complete.
K10 = int8_gemm.  K13 = row_quant(LN) -> int8_gemm (bf16 qkv, q * 1/sqrt(d)
in fp32 before the rounding, as the TPU kernel rounds it) -> attention (fp32)
-> row_quant per head group, each group's codes padded with zeros to a
multiple of 32 -> int8_gemm with a dequant per group.  K12 = K13's chain with
one group.  K11 = K9 -> K10.  K14 = K12's chain with an fp32 out-proj output
(y1) -> row_quant(LN2) -> int8_gemm (act, h requantized per hidden chunk)
-> int8_gemm residual-first, so its fp32 sum runs in the TPU kernel's
order, (y1 + b2) + part_0 + part_1 ...  K15 = K11's chain with LN eps 1e-6
on y and the gamma epilogue in its second GEMM onto the block input.

Layouts.  The public functions keep the JAX signatures and layouts: ``w8``
[K, N] with ``w_scale`` [N]; K13's ``wqkv8_g`` [G, W, 3gD] and ``wout8_g``
[G, gD, W].  Hopper's int8 tensor cores take both operands K-major, so the
kernels read every weight as [N, K] rows.  ``int8_weight`` and
``int8_attn_weights`` lay the weights out so once, at quantize time, and
return views of JAX's shapes over that storage; the wrappers read such views
in place and copy any other layout on each call.

Every wrapper runs its plain PyTorch version when handed CPU tensors and
launches its kernels (or raises) for CUDA tensors — there is no fallback.
Each counts its launches in a plain integer attribute
(``quant_matmul_fused.launches``).  The plain versions take the integer
products in float64, exact for int8 codes (``ops/quant.int_matmul``), and
round where the kernels and the TPU kernels round.
"""

from __future__ import annotations

import math
from functools import partial
from types import SimpleNamespace

import torch

from . import block_kernel as bk
from ._build import launch
from .block_kernel import ACTS, _check, _ln_f32, _vec_f32, act_code, act_f32
from .quant import int_matmul

# a grouped K's span is padded to a multiple of 32 bytes: the int8 GEMM reads
# a span as 128-byte k-steps and a rest of at most 32 bytes as one 32-byte
# step (K13's 144-wide groups: 160 = 128 + 32)
GEMM_BK = 32
# the int8 GEMM's output tile is GEMM_BM x GEMM_BM (its quantized output
# counts the tiles of each panel of GEMM_BM rows)
GEMM_BM = 128


def _group_pad(width: int) -> int:
    return -(-width // GEMM_BK) * GEMM_BK


# the int8 GEMM's K is a multiple of 16 (TMA row strides are multiples of 16
# bytes).  A weight whose K is not (the im2col of a patch-14 tower, 14 * 14 *
# 3 = 588) is stored with zero columns up to the next multiple (592), and
# K8's activation codes with zeros there too (row_quant's group_pad): the
# scales are the max over the K real values, so the int32 sums, and K8's
# output, are those of the unpadded product.
GEMM_K_ALIGN = 16


def _k_pad(k: int) -> int:
    return -(-k // GEMM_K_ALIGN) * GEMM_K_ALIGN


# ---------------------------------------------------------------------------
# weight layouts
# ---------------------------------------------------------------------------


def int8_weight(w8: torch.Tensor) -> torch.Tensor:
    """[K, N] int8 -> the same values as a [K, N] view of K-major storage
    ([N, Kp] row-major, Kp = K rounded up to 16, zero columns past K), which
    the kernels read in place."""
    k, n = w8.shape
    kp = _k_pad(k)
    if kp == k:
        return w8.t().contiguous().t()
    store = torch.zeros(n, kp, dtype=w8.dtype, device=w8.device)
    store[:, :k] = w8.t()
    return store[:, :k].t()


def _kmajor(w8: torch.Tensor, pad_k: bool = False) -> torch.Tensor:
    """The [N, K] row-major operand behind a [K, N] weight (a view of
    ``int8_weight`` storage or of a column slice of it, else a copy).  With
    ``pad_k``, [N, Kp], Kp = K rounded up to 16: a view of storage whose
    rows are Kp apart, or a copy with zero columns past K.  A view's columns
    past K may hold another weight's values (a K-slice of a wider weight),
    so only a caller whose codes are zero past K passes ``pad_k``: K8."""
    k, n = w8.shape
    kp = _k_pad(k) if pad_k else k
    if w8.stride() == (1, kp):
        return torch.as_strided(w8, (n, kp), (kp, 1))
    if kp == k:
        return w8.t().contiguous()
    out = torch.zeros(n, kp, dtype=w8.dtype, device=w8.device)
    out[:, :k] = w8.t()
    return out


def int8_attn_weights(wqkv8_g: torch.Tensor, wout8_g: torch.Tensor):
    """K13's grouped weights -> the same values as views of JAX's shapes over
    the kernels' storage: ``wqkv8_g`` [G, W, 3gD] over [G, 3gD, W], and
    ``wout8_g`` [G, gD, W] over [W, G, P], each group's gD rows of K padded
    with zeros to P, a multiple of 32."""
    g, gd, w = wout8_g.shape
    qkv = wqkv8_g.transpose(1, 2).contiguous().transpose(1, 2)
    out = torch.zeros(w, g, _group_pad(gd), dtype=torch.int8,
                      device=wout8_g.device)
    out[:, :, :gd] = wout8_g.permute(2, 0, 1)
    return qkv, out[:, :, :gd].permute(1, 2, 0)


def _qkv_operand(wqkv8_g):
    """[G, W, 3gD] -> the [G*3gD, W] operand (a view of ``int8_attn_weights``
    storage, else a copy)."""
    g, w, c = wqkv8_g.shape
    return wqkv8_g.transpose(1, 2).reshape(g * c, w)


def _out_operand(wout8_g):
    """[G, gD, W] -> the [W, G*P] operand, each group's K padded to P."""
    g, gd, w = wout8_g.shape
    p = _group_pad(gd)
    if wout8_g.stride() == (p, 1, g * p):       # int8_attn_weights storage
        return torch.as_strided(wout8_g, (w, g * p), (g * p, 1))
    out = torch.zeros(w, g, p, dtype=torch.int8, device=wout8_g.device)
    out[:, :, :gd] = wout8_g.permute(2, 0, 1)
    return out.reshape(w, g * p)


# ---------------------------------------------------------------------------
# the pieces: plain versions and CUDA wrappers
# ---------------------------------------------------------------------------


def row_quant_plain(x, ln_scale=None, ln_bias=None, *, eps=1e-5, group=0,
                    group_pad=0):
    """Plain version of ``row_quant`` (same signature)."""
    xf = x.float()
    if ln_scale is not None:
        xf = _ln_f32(xf, ln_scale, ln_bias, eps)
    m, k = xf.shape
    kg = group or k
    xg = xf.reshape(m, k // kg, kg)
    s = xg.abs().amax(-1).clamp_min(1e-12) * (1.0 / 127.0)      # [M, G]
    q = torch.round(xg / s[..., None]).clamp(-127, 127).to(torch.int8)
    if group_pad > kg:
        q = torch.nn.functional.pad(q, (0, group_pad - kg))
    return q.reshape(m, -1), s


# an H100 block's shared memory, which holds row_quant's row
SMEM_MAX = 232448


def row_quant_bytes(k: int, elem: int, ln: bool) -> int:
    """The shared memory ``row_quant``'s kernel takes for a row of ``k``
    values of ``elem`` bytes: the row, and with LN its fp32 LN values, each
    rounded up to 16 bytes."""
    return -(-k * elem // 16) * 16 + (-(-k * 4 // 16) * 16 if ln else 0)


def row_quant(x, ln_scale=None, ln_bias=None, *, eps=1e-5, group=0,
              group_pad=0):
    """x [M, K] (bf16 or fp32) -> (codes [M, G*P] int8, scales [M, G] fp32):
    an optional fp32 LN over the row, then per group of ``group`` columns
    (default the whole row, G = 1) s = max(amax, 1e-12) * (1/127) and codes
    clip(round(v / s), -127, 127), each group's codes padded with zeros to
    ``group_pad`` (P, default the group width).  Kernel ``row_quant``, which
    reads each row once into shared memory: on the card a row must fit in a
    block's (``row_quant_bytes`` <= ``SMEM_MAX``: fp32 with LN up to 29,056
    columns, fp32 alone 58,112) and a wider one raises."""
    if not x.is_cuda:
        return row_quant_plain(x, ln_scale, ln_bias, eps=eps, group=group,
                               group_pad=group_pad)
    m, k = x.shape
    kg = group or k
    kp = max(group_pad, kg)
    if k % kg:
        raise ValueError(f"group {kg} does not divide the row width {k}")
    dev = x.device
    _check("x", x, (torch.bfloat16, torch.float32), (m, k), dev)
    need = row_quant_bytes(k, x.element_size(), ln_scale is not None)
    if need > SMEM_MAX:
        raise ValueError(f"row_quant holds a row in shared memory: {k} "
                         f"columns of {x.dtype}"
                         f"{'' if ln_scale is None else ' with LN'} take "
                         f"{need} bytes, past a block's {SMEM_MAX}")
    ln = ((None, None) if ln_scale is None else
          (_vec_f32(ln_scale, k, dev, "ln_scale"),
           _vec_f32(ln_bias, k, dev, "ln_bias")))
    q = torch.empty((m, (k // kg) * kp), dtype=torch.int8, device=dev)
    s = torch.empty((m, k // kg), dtype=torch.float32, device=dev)
    launch("aihab_row_quant", dev, x.data_ptr(), int(x.dtype == torch.float32),
           m, k, kg, kp, *(None if t is None else t.data_ptr() for t in ln),
           eps, q.data_ptr(), s.data_ptr())
    row_quant.launches += 1
    return q, s


def int8_gemm_plain(a8, sa, wt, ws, bias, *, act="none", residual=None,
                    out_dtype=torch.bfloat16, q_scale=1.0, q_width=0,
                    groups=1, residual_first=False, gamma=None, out_group=0,
                    out_group_pad=0):
    """Plain version of ``int8_gemm`` (same signature)."""
    if out_dtype == torch.int8:
        y = int8_gemm_plain(a8, sa, wt, ws, bias, act=act, residual=residual,
                            out_dtype=torch.float32, q_scale=q_scale,
                            q_width=q_width, groups=groups,
                            residual_first=residual_first, gamma=gamma)
        return row_quant_plain(y, group=out_group, group_pad=out_group_pad)
    m, k = a8.shape
    kg = k // groups
    sa = sa.reshape(m, groups).float()
    ws = ws.float()[None, :]
    for g in range(groups):
        cols = slice(g * kg, (g + 1) * kg)
        part = int_matmul(a8[:, cols], wt[:, cols].t()) * (sa[:, g:g + 1] * ws)
        if g:
            y = y + part
        elif residual_first:
            y = (residual.float() + bias.float()[None, :]) + part
        else:
            y = part + bias.float()[None, :]
            if groups > 1:
                y = y + residual.float()
    if groups == 1 and not residual_first:
        y = act_f32(y, act)
        if q_width:
            is_q = torch.arange(y.shape[-1], device=y.device) % (3 * q_width) \
                < q_width
            y = torch.where(is_q, y * q_scale, y)
        if gamma is not None:
            y = y * gamma.float()
        if residual is not None:
            y = y + residual.float()
    return y.to(out_dtype)


def int8_gemm(a8, sa, wt, ws, bias, *, act="none", residual=None,
              out_dtype=torch.bfloat16, q_scale=1.0, q_width=0, groups=1,
              residual_first=False, gamma=None, out_group=0, out_group_pad=0):
    """a8 [M, K] int8 (row scales ``sa`` [M, groups]) times ``wt`` [N, K]
    int8 (K-major, column scales ``ws`` [N]) -> [M, N] in ``out_dtype``.

    groups = 1: act(acc * (sa * ws) + bias), the q columns of each head group
    (``q_width`` wide, groups 3 q_width wide) times ``q_scale``, times
    ``gamma`` [N] (K15's layer scale), + residual.
    groups > 1: K is ``groups`` equal spans; span g's int32 sum is
    dequantized with ``sa[:, g]``, and the partials sum in fp32 as
    (part_0 + bias) + residual + part_1 + ... (K13's out-proj).
    ``residual_first`` (any groups, an fp32 residual): (residual + bias) +
    part_0 + part_1 + ... (K14's c_proj).
    ``out_dtype=torch.int8`` (one group, no residual, q-scale or gamma):
    the fp32 y requantized, (codes [M, G * P] int8, scales [M, G] fp32) =
    ``row_quant(y, group=out_group, group_pad=out_group_pad)``, G = N /
    ``out_group`` (default the whole row), in the same launch (K9, K11,
    K14's c_fc, K15); past N = 128 x the card's SMs, and for the gelu_poly
    forms past sig5, in a second one.  Kernel ``int8_gemm``."""
    if not a8.is_cuda:
        return int8_gemm_plain(a8, sa, wt, ws, bias, act=act,
                               residual=residual, out_dtype=out_dtype,
                               q_scale=q_scale, q_width=q_width,
                               groups=groups, residual_first=residual_first,
                               gamma=gamma, out_group=out_group,
                               out_group_pad=out_group_pad)
    if out_dtype == torch.int8:
        if (groups > 1 or residual_first or residual is not None or q_width
                or gamma is not None):
            raise ValueError("the quantized output takes one group and no "
                             "residual, q-scale or gamma")
        if (not bk._in_epilogue(act_code(act))
                or -(-wt.shape[0] // GEMM_BM) > _sm_count(a8.device)):
            # a gelu_poly form past sig5 has no epilogue, and a row of more
            # tiles than the card has SMs no launch of the quantized output:
            # fp32 y (act_pass), then row_quant
            y = int8_gemm(a8, sa, wt, ws, bias, act=act,
                          out_dtype=torch.float32)
            return row_quant(y, group=out_group, group_pad=out_group_pad)
        out = _int8_gemm_qout(a8, sa, wt, ws, bias, act, out_group,
                              out_group_pad)
        int8_gemm.launches += 1
        return out
    m, k = a8.shape
    n = wt.shape[0]
    if k % 16 or n % 8 or q_width % 2:
        raise ValueError(f"int8_gemm needs K a multiple of 16, N of 8 and an "
                         f"even q_width, got {k}, {n}, {q_width}")
    if residual_first and (k % (groups * GEMM_BK) or act != "none" or q_width
                           or residual is None
                           or residual.dtype != torch.float32):
        raise ValueError("residual-first int8_gemm needs spans that are "
                         f"multiples of {GEMM_BK}, no activation or q-scale, "
                         "and an fp32 residual")
    if groups > 1 and not residual_first and (
            k % (groups * GEMM_BK) or act != "none" or q_width
            or residual is None or residual.dtype != out_dtype):
        raise ValueError("grouped int8_gemm needs spans that are multiples of "
                         f"{GEMM_BK}, no activation or q-scale, and a "
                         "residual of the output's dtype")
    if gamma is not None and (groups > 1 or residual_first):
        raise ValueError("the gamma epilogue takes one group, not "
                         "residual-first")
    code = act_code(act)
    fused = bk._in_epilogue(code)
    if not fused and (q_width or gamma is not None):
        raise ValueError("the q-scale and gamma epilogues take no gelu_poly "
                         "form past sig5")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not bf16/fp32")
    dev = a8.device
    _check("a8", a8, torch.int8, (m, k), dev)
    _check("wt", wt, torch.int8, (n, k), dev)
    sa = sa.to(dtype=torch.float32).contiguous()
    if sa.numel() != m * groups or sa.device != dev:
        raise ValueError(f"sa must hold {m} x {groups} scales on {dev}")
    ws = _vec_f32(ws, n, dev, "ws")
    bias = _vec_f32(bias, n, dev, "bias")
    if gamma is not None:
        gamma = _vec_f32(gamma, n, dev, "gamma")
    if residual is not None:
        _check("residual", residual, (torch.bfloat16, torch.float32), (m, n),
               dev)
    # a gelu_poly form past sig5: the GEMM stores act-free fp32, act_pass
    # applies the activation and adds the residual
    r_gemm = residual if fused else None
    y = torch.empty((m, n), dtype=out_dtype if fused else torch.float32,
                    device=dev)
    launch("aihab_int8_gemm", dev, a8.data_ptr(), sa.data_ptr(),
           wt.data_ptr(), ws.data_ptr(), bias.data_ptr(),
           None if gamma is None else gamma.data_ptr(),
           None if r_gemm is None else r_gemm.data_ptr(),
           int(r_gemm is not None and r_gemm.dtype == torch.float32),
           y.data_ptr(), int(y.dtype == torch.float32), m, n, k, groups,
           int(residual_first), code if fused else 0, q_scale, q_width,
           max(3 * q_width, 1))
    if not fused:
        y = bk.act_pass(y, code, residual, out_dtype=out_dtype)
    int8_gemm.launches += 1
    return y


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _int8_gemm_qout(a8, sa, wt, ws, bias, act, out_group, out_group_pad):
    """``int8_gemm``'s quantized output on the card: one launch of the
    int8 GEMM in its QOUT mode (``csrc/quant_kernels.cu``), which keeps each
    y tile in shared memory and requantizes it once the row maxima of its
    128-row panel are complete.  A block waits there for the panel's other
    tiles, so N takes at most as many 128-column tiles as the card has SMs
    (a panel's tiles on distinct blocks)."""
    m, k = a8.shape
    n = wt.shape[0]
    kg = out_group or n
    kp = max(out_group_pad, kg)
    n_groups = n // kg
    if k % 16 or n % 8 or n % kg or kg % 8 or kp % 8 or (
            n_groups > 1 and kg < GEMM_BM):
        raise ValueError(f"the quantized int8_gemm needs K a multiple of 16, "
                         f"N of 8, groups of a multiple of 8 columns (at "
                         f"least {GEMM_BM} when N has more than one) and a "
                         f"pad to a multiple of 8; got K {k}, N {n}, group "
                         f"{kg} padded to {kp}")
    dev = a8.device
    if -(-n // GEMM_BM) > _sm_count(dev):
        raise ValueError(f"the quantized int8_gemm takes N up to {GEMM_BM} "
                         f"x the card's {_sm_count(dev)} SMs (a panel's "
                         f"tiles on distinct blocks); got N {n}")
    _check("a8", a8, torch.int8, (m, k), dev)
    _check("wt", wt, torch.int8, (n, k), dev)
    sa = sa.to(dtype=torch.float32).contiguous()
    if sa.numel() != m or sa.device != dev:
        raise ValueError(f"sa must hold {m} scales on {dev}")
    ws = _vec_f32(ws, n, dev, "ws")
    bias = _vec_f32(bias, n, dev, "bias")
    # the row maxima [M, G] and the per-panel tile counters, zero
    ctl = torch.zeros(m * n_groups + -(-m // GEMM_BM), dtype=torch.int32,
                      device=dev)
    q = torch.empty((m, n_groups * kp), dtype=torch.int8, device=dev)
    s = torch.empty((m, n_groups), dtype=torch.float32, device=dev)
    launch("aihab_int8_gemm_qout", dev, a8.data_ptr(), sa.data_ptr(),
           wt.data_ptr(), ws.data_ptr(), bias.data_ptr(), m, n, k, act_code(act),
           ctl.data_ptr(), q.data_ptr(), s.data_ptr(), n_groups, kg, kp)
    return q, s


_PLAIN = SimpleNamespace(row_quant=row_quant_plain, int8_gemm=int8_gemm_plain,
                         attention=partial(bk.attention_plain,
                                           normalize_p=True))
_KERNELS = SimpleNamespace(row_quant=row_quant, int8_gemm=int8_gemm,
                           attention=bk.attention)


# ---------------------------------------------------------------------------
# the compositions, shared by the kernel and plain paths
# ---------------------------------------------------------------------------


def _check_act(act):
    if act not in ACTS:
        raise ValueError(f"unknown activation '{act}'")


def _k8(ops, x, w8, w_scale, bias, act, residual, ln_scale, ln_bias, ln_eps):
    x8, sx = ops.row_quant(x, ln_scale, ln_bias, eps=ln_eps,
                           group_pad=_k_pad(x.shape[-1]))
    return ops.int8_gemm(x8, sx, _kmajor(w8, pad_k=True), w_scale, bias,
                         act=act, residual=residual, out_dtype=x.dtype)


def _k9(ops, x, w8, w_scale, bias, ln_scale, ln_bias, act, ln_eps):
    x8, sx = ops.row_quant(x, ln_scale, ln_bias, eps=ln_eps)
    return ops.int8_gemm(x8, sx, _kmajor(w8), w_scale, bias, act=act,
                         out_dtype=torch.int8)


def _k10(ops, x8, x_scale, w8, w_scale, bias, residual):
    return ops.int8_gemm(x8, x_scale, _kmajor(w8), w_scale, bias,
                         residual=residual, out_dtype=residual.dtype)


def _int8_attn(ops, x2, b, s, wqkv8, qkv_scale, b_qkv, ln_scale, ln_bias,
               heads, seq_len):
    """K12's chain up to the out-proj's input: LN1 -> quantize -> int8 QKV
    (bf16, q * 1/sqrt(d) in fp32 before the store) -> attention over every
    head (fp32, P normalised before its bf16 cast, as in the TPU kernel) ->
    the whole row requantized.  Returns (a8, sa)."""
    w = x2.shape[1]
    x8, sx = ops.row_quant(x2, ln_scale, ln_bias)
    qkv = ops.int8_gemm(x8, sx, _kmajor(wqkv8), qkv_scale, b_qkv,
                        out_dtype=torch.bfloat16,
                        q_scale=1.0 / math.sqrt(w // heads), q_width=w)
    attn = ops.attention(qkv.reshape(b, s, 3 * w), heads, seq_len,
                         q_scaled=True, out_dtype=torch.float32,
                         normalize_p=True)
    return ops.row_quant(attn.reshape(b * s, w))


def _k12(ops, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out, ln_scale,
         ln_bias, heads, seq_len, out_dtype):
    """K12 over [B, S, W] x; out-proj + b_out + x stored as ``out_dtype``
    ([B*S, W]; K14 keeps it fp32)."""
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    a8, sa = _int8_attn(ops, x2, b, s, wqkv8, qkv_scale, b_qkv, ln_scale,
                        ln_bias, heads, seq_len)
    return ops.int8_gemm(a8, sa, _kmajor(wout8), out_scale, b_out,
                         residual=x2, out_dtype=out_dtype)


def _k11(ops, x, w1_8, w1_scale, b1, w2_8, w2_scale, b2, ln_scale, ln_bias,
         act, ln_eps):
    h8, hs = _k9(ops, x, w1_8, w1_scale, b1, ln_scale, ln_bias, act, ln_eps)
    return _k10(ops, h8, hs, w2_8, w2_scale, b2, x)


def _k15(ops, y, residual, ln_scale, ln_bias, w1_8, w1_scale, b1, w2_8,
         w2_scale, b2, gamma, act, ln_eps):
    x8, sx = ops.row_quant(y, ln_scale, ln_bias, eps=ln_eps)
    h8, hs = ops.int8_gemm(x8, sx, _kmajor(w1_8), w1_scale, b1, act=act,
                           out_dtype=torch.int8)
    return ops.int8_gemm(h8, hs, _kmajor(w2_8), w2_scale, b2,
                         residual=residual, out_dtype=y.dtype, gamma=gamma)


def _k14(ops, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out, ln1_scale,
         ln1_bias, w1_8, w1_scale, b1, w2_8, w2_scale, b2, ln2_scale,
         ln2_bias, heads, mlp_chunks, act):
    b, s, w = x.shape
    y1 = _k12(ops, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out,
              ln1_scale, ln1_bias, heads, s, torch.float32)
    l8, sl = ops.row_quant(y1, ln2_scale, ln2_bias)
    ch = w1_8.shape[1] // mlp_chunks
    h8, hs = ops.int8_gemm(l8, sl, _kmajor(w1_8), w1_scale, b1, act=act,
                           out_dtype=torch.int8, out_group=ch,
                           out_group_pad=_group_pad(ch))
    out = ops.int8_gemm(h8, hs, _out_operand(w2_8.reshape(mlp_chunks, ch, w)),
                        w2_scale, b2, residual=y1, out_dtype=x.dtype,
                        groups=mlp_chunks, residual_first=True)
    return out.reshape(b, s, w)


def _k13(ops, x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g, out_scale, b_out,
         ln_scale, ln_bias, heads, n_groups, ln_eps, seq_len):
    b, s, w = x.shape
    d = w // heads
    gd = heads // n_groups * d
    x2 = x.reshape(b * s, w)
    x8, sx = ops.row_quant(x2, ln_scale, ln_bias, eps=ln_eps)
    qkv = ops.int8_gemm(x8, sx, _qkv_operand(wqkv8_g), qkv_scale_g.reshape(-1),
                        b_qkv_g.reshape(-1), out_dtype=torch.bfloat16,
                        q_scale=1.0 / math.sqrt(d), q_width=gd)
    attn = ops.attention(qkv.reshape(b, s, 3 * w), heads, seq_len,
                         group_heads=heads // n_groups, q_scaled=True,
                         out_dtype=torch.float32)
    a8, sa = ops.row_quant(attn.reshape(b * s, w), group=gd,
                           group_pad=_group_pad(gd))
    out = ops.int8_gemm(a8, sa, _out_operand(wout8_g), out_scale, b_out,
                        residual=x2, out_dtype=x.dtype, groups=n_groups)
    return out.reshape(b, s, w)


# ---------------------------------------------------------------------------
# the TPU kernels' functions
# ---------------------------------------------------------------------------


def quant_matmul_fused_plain(x, w8, w_scale, bias, act: str = "none",
                             residual=None, ln_scale=None, ln_bias=None,
                             ln_eps: float = 1e-5):
    """Plain version of ``quant_matmul_fused`` (same signature)."""
    _check_act(act)
    return _k8(_PLAIN, x, w8, w_scale, bias, act, residual, ln_scale, ln_bias,
               ln_eps)


def quant_matmul_fused(x, w8, w_scale, bias, act: str = "none",
                       residual=None, ln_scale=None, ln_bias=None,
                       ln_eps: float = 1e-5):
    """y = act(dequant(q(opt_LN(x)) @ w8) + bias) [+ residual] (K8).

    x [M, K] bf16/fp32, w8 [K, N] int8, w_scale [N] fp32, bias [N] fp32;
    ``ln_scale``/``ln_bias`` add an fp32 LayerNorm over K before the
    quantize; ``act`` one of none, quick_gelu, gelu_tanh, gelu_poly.  Output
    in x's dtype.  Any K: past a multiple of 16 both operands carry zero
    columns into the GEMM (``GEMM_K_ALIGN``)."""
    _check_act(act)
    if not x.is_cuda:
        return quant_matmul_fused_plain(x, w8, w_scale, bias, act, residual,
                                        ln_scale, ln_bias, ln_eps)
    out = _k8(_KERNELS, x, w8, w_scale, bias, act, residual, ln_scale,
              ln_bias, ln_eps)
    quant_matmul_fused.launches += 1
    return out


def quant_matmul_fused_qout_plain(x, w8, w_scale, bias, ln_scale, ln_bias,
                                  act: str = "quick_gelu",
                                  ln_eps: float = 1e-5):
    """Plain version of ``quant_matmul_fused_qout`` (same signature)."""
    _check_act(act)
    return _k9(_PLAIN, x, w8, w_scale, bias, ln_scale, ln_bias, act, ln_eps)


def quant_matmul_fused_qout(x, w8, w_scale, bias, ln_scale, ln_bias,
                            act: str = "quick_gelu", ln_eps: float = 1e-5):
    """LN -> W8A8 GEMM -> act -> requantize (K9): returns (y8 [M, N] int8,
    y_scale [M, 1] fp32), the requantize over each whole row of the fp32
    activation."""
    _check_act(act)
    if not x.is_cuda:
        return quant_matmul_fused_qout_plain(x, w8, w_scale, bias, ln_scale,
                                             ln_bias, act, ln_eps)
    out = _k9(_KERNELS, x, w8, w_scale, bias, ln_scale, ln_bias, act, ln_eps)
    quant_matmul_fused_qout.launches += 1
    return out


def quant_matmul_q8in_plain(x8, x_scale, w8, w_scale, bias, residual):
    """Plain version of ``quant_matmul_q8in`` (same signature)."""
    return _k10(_PLAIN, x8, x_scale, w8, w_scale, bias, residual)


def quant_matmul_q8in(x8, x_scale, w8, w_scale, bias, residual):
    """y = dequant(x8 @ w8) + bias + residual for rows quantized before
    (K10): x8 [M, K] int8 with x_scale [M, 1]; output in the residual's
    dtype."""
    if not x8.is_cuda:
        return quant_matmul_q8in_plain(x8, x_scale, w8, w_scale, bias,
                                       residual)
    out = _k10(_KERNELS, x8, x_scale, w8, w_scale, bias, residual)
    quant_matmul_q8in.launches += 1
    return out


def _k13_seq_len(x, heads, n_groups, padded_io, seq_len):
    if heads % n_groups:
        raise ValueError(f"n_groups {n_groups} must divide heads {heads} "
                         "(a floored group size would silently drop heads)")
    if padded_io:
        if seq_len is None:
            raise ValueError("padded_io=True requires seq_len")
        if x.shape[1] % 16:
            raise ValueError(f"padded_io input S={x.shape[1]} not a multiple "
                             "of 16")
        return seq_len
    return x.shape[1]


def quant_attn_block_split_plain(x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g,
                                 out_scale, b_out, ln_scale, ln_bias,
                                 heads: int, n_groups: int,
                                 ln_eps: float = 1e-5,
                                 padded_io: bool = False,
                                 seq_len: int | None = None):
    """Plain version of ``quant_attn_block_split`` (same signature); its
    attention normalises P before the bf16 cast, as the TPU kernel does."""
    seq_len = _k13_seq_len(x, heads, n_groups, padded_io, seq_len)
    return _k13(_PLAIN, x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g, out_scale,
                b_out, ln_scale, ln_bias, heads, n_groups, ln_eps, seq_len)


def quant_attn_block_split(x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g,
                           out_scale, b_out, ln_scale, ln_bias, heads: int,
                           n_groups: int, ln_eps: float = 1e-5,
                           padded_io: bool = False,
                           seq_len: int | None = None):
    """x [B, S, W] -> x + int8_out_proj(MHA(int8_qkv(LN(x)))) over
    ``n_groups`` head groups (K13), output in x's dtype.

    ``wqkv8_g`` [G, W, 3gD] (group j's columns q_j | k_j | v_j),
    ``qkv_scale_g``/``b_qkv_g`` [G, 3gD], ``wout8_g`` [G, gD, W]
    (``regroup_attn_weights``).  The attention core is bf16 whatever x's
    dtype (q * 1/sqrt(d) in fp32 before its cast), its output fp32; each
    head group's output is requantized with its own row scale, and the
    group partials of the out-proj sum in fp32 in group order.
    ``padded_io``: x arrives padded past the real sequence ``seq_len``
    (S a multiple of 16); keys at or beyond it are masked and the padded
    result is returned whole.  No padding is needed otherwise."""
    if not x.is_cuda:
        return quant_attn_block_split_plain(
            x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g, out_scale, b_out,
            ln_scale, ln_bias, heads, n_groups, ln_eps, padded_io, seq_len)
    seq_len = _k13_seq_len(x, heads, n_groups, padded_io, seq_len)
    out = _k13(_KERNELS, x, wqkv8_g, qkv_scale_g, b_qkv_g, wout8_g, out_scale,
               b_out, ln_scale, ln_bias, heads, n_groups, ln_eps, seq_len)
    quant_attn_block_split.launches += 1
    return out


def quant_attn_block_fused_plain(x, wqkv8, qkv_scale, b_qkv, wout8,
                                 out_scale, b_out, ln_scale, ln_bias,
                                 heads: int, padded_io: bool = False,
                                 seq_len: int | None = None):
    """Plain version of ``quant_attn_block_fused`` (same signature)."""
    seq_len = _k13_seq_len(x, heads, 1, padded_io, seq_len)
    return _k12(_PLAIN, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out,
                ln_scale, ln_bias, heads, seq_len, x.dtype).reshape(x.shape)


def quant_attn_block_fused(x, wqkv8, qkv_scale, b_qkv, wout8, out_scale,
                           b_out, ln_scale, ln_bias, heads: int,
                           padded_io: bool = False,
                           seq_len: int | None = None):
    """x [B, S, W] -> x + int8_out_proj(MHA(int8_qkv(LN(x)))) (K12), output
    in x's dtype.  ``wqkv8`` [W, 3W] (q | k | v), ``wout8`` [W, W]; scales
    [3W], [W] and fp32 biases.  The attention core is bf16 (q * 1/sqrt(d)
    in fp32 before its cast), its fp32 output requantized over the whole
    row.  ``padded_io``/``seq_len`` as in ``quant_attn_block_split``: the
    TPU kernel padded S to a multiple of 16 itself, the kernels here mask
    their ragged edges and need no padding."""
    if not x.is_cuda:
        return quant_attn_block_fused_plain(
            x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out, ln_scale,
            ln_bias, heads, padded_io, seq_len)
    seq_len = _k13_seq_len(x, heads, 1, padded_io, seq_len)
    out = _k12(_KERNELS, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out,
               ln_scale, ln_bias, heads, seq_len, x.dtype)
    quant_attn_block_fused.launches += 1
    return out.reshape(x.shape)


def quant_mlp_block_fused_plain(x, w1_8, w1_scale, b1, w2_8, w2_scale, b2,
                                ln_scale, ln_bias, act: str = "quick_gelu",
                                ln_eps: float = 1e-5, tile_m: int = 0):
    """Plain version of ``quant_mlp_block_fused`` (same signature)."""
    _check_act(act)
    return _k11(_PLAIN, x, w1_8, w1_scale, b1, w2_8, w2_scale, b2, ln_scale,
                ln_bias, act, ln_eps)


def quant_mlp_block_fused(x, w1_8, w1_scale, b1, w2_8, w2_scale, b2,
                          ln_scale, ln_bias, act: str = "quick_gelu",
                          ln_eps: float = 1e-5, tile_m: int = 0):
    """x [M, W] -> x + int8_c_proj(requant(act(int8_c_fc(quant(LN(x))))))
    (K11), output in x's dtype: ``w1_8`` [W, H], ``w2_8`` [H, W], the hidden
    row requantized whole, c_proj summed as (part + b2) + x.  ``tile_m`` was
    the TPU kernel's row tile: accepted and ignored."""
    _check_act(act)
    if not x.is_cuda:
        return quant_mlp_block_fused_plain(x, w1_8, w1_scale, b1, w2_8,
                                           w2_scale, b2, ln_scale, ln_bias,
                                           act, ln_eps)
    out = _k11(_KERNELS, x, w1_8, w1_scale, b1, w2_8, w2_scale, b2, ln_scale,
               ln_bias, act, ln_eps)
    quant_mlp_block_fused.launches += 1
    return out


def _check_chunks(w1_8, mlp_chunks):
    if mlp_chunks < 1 or w1_8.shape[1] % mlp_chunks:
        raise ValueError(f"mlp_chunks {mlp_chunks} does not divide hidden "
                         f"{w1_8.shape[1]}")


def quant_full_block_fused_plain(x, wqkv8, qkv_scale, b_qkv, wout8, out_scale,
                                 b_out, ln1_scale, ln1_bias, w1_8, w1_scale,
                                 b1, w2_8, w2_scale, b2, ln2_scale, ln2_bias,
                                 heads: int, *, mlp_chunks: int = 1,
                                 act: str = "quick_gelu",
                                 images_per_program: int = 1):
    """Plain version of ``quant_full_block_fused`` (same signature)."""
    _check_act(act)
    _check_chunks(w1_8, mlp_chunks)
    return _k14(_PLAIN, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out,
                ln1_scale, ln1_bias, w1_8, w1_scale, b1, w2_8, w2_scale, b2,
                ln2_scale, ln2_bias, heads, mlp_chunks, act)


def quant_full_block_fused(x, wqkv8, qkv_scale, b_qkv, wout8, out_scale,
                           b_out, ln1_scale, ln1_bias, w1_8, w1_scale, b1,
                           w2_8, w2_scale, b2, ln2_scale, ln2_bias,
                           heads: int, *, mlp_chunks: int = 1,
                           act: str = "quick_gelu",
                           images_per_program: int = 1):
    """x [B, S, W] -> one whole int8 transformer block (K14), output in x's
    dtype: K12 with the mid-block residual y1 kept in fp32, then LN2 ->
    quantize -> int8 c_fc -> act -> the hidden row requantized per
    ``mlp_chunks`` slice (each slice its own row scale) -> int8 c_proj,
    out = (y1 + b2) + the chunk partials in order.  ``images_per_program``
    was the TPU kernel's grid tiling (the math is invariant to it): accepted
    and ignored."""
    _check_act(act)
    _check_chunks(w1_8, mlp_chunks)
    if not x.is_cuda:
        return quant_full_block_fused_plain(
            x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out, ln1_scale,
            ln1_bias, w1_8, w1_scale, b1, w2_8, w2_scale, b2, ln2_scale,
            ln2_bias, heads, mlp_chunks=mlp_chunks, act=act)
    out = _k14(_KERNELS, x, wqkv8, qkv_scale, b_qkv, wout8, out_scale, b_out,
               ln1_scale, ln1_bias, w1_8, w1_scale, b1, w2_8, w2_scale, b2,
               ln2_scale, ln2_bias, heads, mlp_chunks, act)
    quant_full_block_fused.launches += 1
    return out


def quant_convnext_mlp_block_plain(y, residual, ln_scale, ln_bias, w1_8,
                                   w1_scale, b1, w2_8, w2_scale, b2, gamma, *,
                                   act: str = "gelu_poly",
                                   ln_eps: float = 1e-6, tile_m: int = 0):
    """Plain version of ``quant_convnext_mlp_block`` (same signature)."""
    _check_act(act)
    return _k15(_PLAIN, y, residual, ln_scale, ln_bias, w1_8, w1_scale, b1,
                w2_8, w2_scale, b2, gamma, act, ln_eps)


def quant_convnext_mlp_block(y, residual, ln_scale, ln_bias, w1_8, w1_scale,
                             b1, w2_8, w2_scale, b2, gamma, *,
                             act: str = "gelu_poly", ln_eps: float = 1e-6,
                             tile_m: int = 0):
    """``residual + gamma * int8_fc2(requant(act(int8_fc1(quant(LN(y))))))``
    over [M, C] rows (K15), output in y's dtype: y the dwconv output,
    ``residual`` the block input, ``w1_8`` [C, H] and ``w2_8`` [H, C] int8
    with fp32 column scales, LN (eps ``ln_eps``), b1, b2 and gamma fp32.
    The fp32 hidden row is requantized whole; fc2 sums res + (part + b2) *
    gamma in fp32.  ``tile_m`` was the TPU kernel's row tile: accepted and
    ignored."""
    _check_act(act)
    if not y.is_cuda:
        return quant_convnext_mlp_block_plain(
            y, residual, ln_scale, ln_bias, w1_8, w1_scale, b1, w2_8,
            w2_scale, b2, gamma, act=act, ln_eps=ln_eps)
    out = _k15(_KERNELS, y, residual, ln_scale, ln_bias, w1_8, w1_scale, b1,
               w2_8, w2_scale, b2, gamma, act, ln_eps)
    quant_convnext_mlp_block.launches += 1
    return out


def regroup_attn_weights(wqkv8, qkv_scale, b_qkv, wout8, heads: int,
                         n_groups: int):
    """[W, 3W] packed q|k|v (+ scales/bias) and [W, W] out-proj -> the
    per-head-group tensors of ``quant_attn_block_split``: [G, W, 3gD],
    [G, 3gD], [G, 3gD] fp32, [G, gD, W] (quant_matmul.py:861)."""
    if heads % n_groups:
        raise ValueError(f"n_groups {n_groups} must divide heads {heads}")
    w = wqkv8.shape[0]
    gd = w // n_groups

    def group_cols(t):   # [..., 3W] (q | k | v) -> [G, ..., 3gD]
        parts = t.reshape(*t.shape[:-1], 3, n_groups, gd)
        return parts.movedim(-2, 0).flatten(-2)

    return (group_cols(wqkv8).contiguous(), group_cols(qkv_scale).contiguous(),
            group_cols(b_qkv.float()).contiguous(),
            wout8.reshape(n_groups, gd, -1).contiguous())


COUNTED = (row_quant, int8_gemm, quant_matmul_fused, quant_matmul_fused_qout,
           quant_matmul_q8in, quant_attn_block_split, quant_attn_block_fused,
           quant_mlp_block_fused, quant_full_block_fused,
           quant_convnext_mlp_block)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
