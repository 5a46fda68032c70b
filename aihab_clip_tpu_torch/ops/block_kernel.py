"""Whole-block transformer kernels on Hopper, with their plain versions.

Ports of ``aihab_clip_tpu/ops/block_kernel.py`` (Pallas, TPU):

  * ``full_block_fused`` (K1, CLIP's main path)  x -> the whole pre-LN block
  * ``attn_block_fused`` (K2)                 x -> x + out(MHA(LN1 x))
  * ``mlp_block_fused``  (K3)                 x -> x + c_proj(act(c_fc(LN2 x)))
  * ``attn_block_split`` (K5, SigLIP's path)  K2 over head groups
  * ``mlp_block_split``  (K4, SigLIP's path)  K3 with the hidden dim in chunks
  * ``convnext_mlp_block`` (K7, ConvNeXt)     res + gamma * fc2(act(fc1(LN y)))
  * ``mlp_block_train``  (K17, differentiable)  K3 with QuickGELU, forward
                         and backward, as a ``torch.autograd.Function``

On the TPU each is one program per image (or row tile) with its weights
resident in VMEM.  On the H100 each is a composition of three hand-written
CUDA kernels (``csrc/block_kernels.cu``, whose header gives the design and
the bound):

  * ``ln_gemm``        fp32 LN row pass (LN(x) stored in bf16) -> bf16
                       GEMM -> bias [+ act] [* q-scale on the q columns]
  * ``attention``      masked multi-head softmax(q k^T / sqrt(d)) v,
                       head_dim in ``HEAD_DIMS``, packed or head-grouped
                       qkv (the flash kernel, bf16 or fp32 output; with P
                       normalised before its cast, K12's and K14's, in two
                       sweeps over the keys)
  * ``gemm_residual``  bf16 GEMM -> bias [* per-column gamma] + residual

Both GEMMs are the one TMA + wgmma kernel (``gemm_kernel``), and the bf16
attention the TMA + wgmma ``flash_attention_kernel``.

K1 = ln_gemm(LN1, W_qkv) -> attention -> gemm_residual(W_out, +x) ->
ln_gemm(LN2, W_fc, act) -> gemm_residual(W_proj, +y1); K2 and K3 are its
two halves.  The TPU kernel's rounding points are kept: qkv, the attention
output and the MLP hidden h are bf16 (JAX casts each to bf16 before its
next product), the mid-block residual y1 stays fp32 inside K1 and is bf16
only at the K2/K3 boundary.

K5 = one ln_gemm over every group's q|k|v columns, with q scaled by
1/sqrt(d) in fp32 before its bf16 store (the TPU kernel's order, which
1/sqrt(72) does not let the scores absorb) -> attention over the grouped
layout with scale 1 -> one gemm_residual over the out-proj rows of all
groups, whose fp32 sum is the TPU kernel's fp32 scratch sum of group
partials.  K4 = per hidden chunk, ln_gemm over that chunk's c_fc columns and
gemm_residual over its c_proj rows, the running partial crossing each chunk
boundary in x's dtype (fp32 with ``f32_partial``), as the TPU kernel stores
it; the chunks are column and row slices of the whole weights, read in
place through the GEMM's row stride.  K7 is K4's recipe over ConvNeXt's
rows: ln_gemm (LN eps 1e-6 of the dwconv output y, gelu_poly) and
gemm_residual with the gamma epilogue onto the block input, chunk 0 storing
res + (p_0 + b2) * gamma and chunk c > 0 acc + p_c * gamma, in y's dtype.

K17's forward is K3's chain with ``ln_gemm`` also storing the c_fc
pre-activation h_pre (bf16) beside h = quick_gelu of the same fp32 value;
its backward is the TPU kernel's dx chain in three launches: ``dy @
W_proj^T`` with a quick_gelu' epilogue storing dh_pre, ``dh_pre @ W_fc^T``
storing dln in fp32, and a row kernel for dx = dy + LN_bwd(dln), which also
stores dln in bf16.  The weight, bias and LN-parameter gradients are
``torch.matmul`` and sums over the emitted tensors, as JAX leaves them to
XLA (``block_kernel.py:319-338``), with JAX's roundings: dgamma and dbeta
from the bf16 dln, dW_proj from h recomputed from the bf16 h_pre.

``gelu_poly`` is JAX's ``gelu_fast_f32``: the form that ``AIHAB_ERF_IMPL``
names (``sig5`` by default, ``sig``, ``rational`` or ``cheb``), read at each
call and validated as in JAX; the wrappers pass the kernels that form's code.

Every wrapper runs its plain PyTorch version when handed CPU tensors and
launches its kernels (or raises) for CUDA tensors — there is no fallback.
Each counts its kernel launches in a plain integer attribute
(``full_block_fused.launches``) so a run can show which path it took.  The
plain versions compute in the input dtype's precision with fp32
accumulation: in fp32 they are the reference math, in bf16 they round where
the kernels round.
"""

from __future__ import annotations

import math
import os
from functools import partial
from types import SimpleNamespace

import torch

from ._build import launch

ACTS = {"none": 0, "quick_gelu": 1, "gelu_tanh": 2, "gelu_poly": 3}
# the kernels' code of each gelu_poly form (csrc/common.cuh), by the
# AIHAB_ERF_IMPL value that names it
GELU_FORMS = {"sig5": 3, "sig": 4, "rational": 5, "cheb": 6}
# the attention kernels' head widths: CLIP ViT-B/L/H (64), SigLIP SO400M
# (72), the LAION ViT-g/14 (88) and ViT-bigG/14 (104)
HEAD_DIMS = (64, 72, 88, 104)

# exact GELU as h * sigmoid(odd poly): the deg-9 fit (block_kernel.py:428)
# and the deg-5 one (:439, the JAX default)
_GELU_SIG_COEF = (1.5956563, 0.07293758, -2.4972331e-4, -6.1162005e-5,
                  2.2381639e-6)
_GELU_SIG5_COEF = (1.5953873, 0.07364605, -6.3791875e-4)
# erf as x * a deg-14 polynomial in u = 2 x^2 / B^2 - 1 (block_kernel.py:365)
_ERF_CHEB_B = 3.6
_ERF_CHEB_COEF = (
    0.0005088007148386333, -0.0011450745066218335, 0.0009553941424598827,
    -0.0023067730846365714, 0.006732319810367243, -0.012240412571535311,
    0.01987247702073693, -0.03221640230820943, 0.048739224765080275,
    -0.0681169523377421, 0.08974328889946132, -0.11378428952616813,
    0.14381484871790284, -0.19549081076627062, 0.3927120878848258,
)


# ---------------------------------------------------------------------------
# plain versions (PyTorch)
# ---------------------------------------------------------------------------


def erf_impl() -> str:
    """The gelu_poly form ``AIHAB_ERF_IMPL`` names (block_kernel.py:388):
    ``sig5`` when unset; a value that names no form raises."""
    impl = os.environ.get("AIHAB_ERF_IMPL", "sig5")
    if impl not in GELU_FORMS:
        raise ValueError(f"AIHAB_ERF_IMPL={impl!r} is not one of "
                         f"{tuple(GELU_FORMS)}")
    return impl


def _erf_rational(x):
    """erf by Abramowitz & Stegun 7.1.26 (block_kernel.py:345)."""
    t = 1.0 / (1.0 + 0.3275911 * x.abs())
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-x * x))


def _erf_cheb(x):
    """erf as an odd polynomial, sign(x) past B (block_kernel.py:375)."""
    ax = x.abs().clamp(max=_ERF_CHEB_B)
    u = ax * ax * (2.0 / (_ERF_CHEB_B * _ERF_CHEB_B)) - 1.0
    p = _ERF_CHEB_COEF[0]
    for c in _ERF_CHEB_COEF[1:]:
        p = p * u + c
    return torch.where(x.abs() < _ERF_CHEB_B, x * p, torch.sign(x))


def gelu_fast_f32(h: torch.Tensor) -> torch.Tensor:
    """gelu_poly: exact GELU in the form ``erf_impl()`` names
    (block_kernel.py:458)."""
    impl = erf_impl()
    if impl in ("sig", "sig5"):
        hc = h.clamp(-7.5, 7.5)
        u = hc * hc
        coef = _GELU_SIG5_COEF if impl == "sig5" else _GELU_SIG_COEF
        p = coef[-1]
        for c in coef[-2::-1]:
            p = c + u * p
        return h * torch.sigmoid(hc * p)
    erf = _erf_cheb if impl == "cheb" else _erf_rational
    return 0.5 * h * (1.0 + erf(h * 0.7071067811865476))


def act_f32(h: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' activations on fp32 ``h`` (block_kernel.py:_act_f32)."""
    if act == "none":
        return h
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(h, approximate="tanh")
    if act == "gelu_poly":
        return gelu_fast_f32(h)
    raise ValueError(f"unknown activation {act!r}")


def act_code(act: str) -> int:
    """The kernels' code of ``act``; gelu_poly's is its current form's."""
    return GELU_FORMS[erf_impl()] if act == "gelu_poly" else ACTS[act]


def _in_epilogue(code: int) -> bool:
    """Whether the GEMM epilogues apply activation ``code`` themselves: the
    gelu_poly forms past sig5 run in ``act_pass`` after the GEMM."""
    return code <= GELU_FORMS["sig5"]


def act_pass(t, code: int, residual=None, *, out_dtype):
    """act(t) [+ residual] for an activation the GEMM epilogues leave out
    (``_in_epilogue``), over the fp32 output ``t`` of a GEMM run without it:
    the fused order, act(acc + bias) then + residual.  Kernel ``act_pass``;
    the wrappers of the GEMMs call it."""
    y = torch.empty(t.shape, dtype=out_dtype, device=t.device)
    launch("aihab_act_pass", t.device, t.data_ptr(), code,
           None if residual is None else residual.data_ptr(),
           int(residual is not None and residual.dtype == torch.float32),
           y.data_ptr(), int(out_dtype == torch.float32), t.numel())
    return y


def _ln_f32(x, scale, bias, eps=1e-5):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm(a, w):
    """Product of compute-dtype operands with fp32 accumulation."""
    return a.float() @ w.float()


def ln_gemm_plain(x, ln_scale, ln_bias, w, bias, *, act="none", eps=1e-5,
                  q_scale=1.0, q_width=0):
    """act(LN(x) @ w + bias) in w's dtype; LN and the epilogue in fp32.
    ``q_width`` > 0: the columns n with n % (3 q_width) < q_width (the q
    block of each head group) are multiplied by ``q_scale`` before the
    rounding to w's dtype."""
    h = act_f32(_mm(_ln_f32(x, ln_scale, ln_bias, eps).to(w.dtype), w)
                + bias.float(), act)
    if q_width:
        is_q = torch.arange(h.shape[-1], device=h.device) % (3 * q_width) \
            < q_width
        h = torch.where(is_q, h * q_scale, h)
    return h.to(w.dtype)


def gemm_residual_plain(a, w, bias, residual, *, out_dtype=None, gamma=None):
    """a @ w [+ bias] + residual, summed in fp32, stored as ``out_dtype``;
    with ``gamma`` [N], residual + (a @ w [+ bias]) * gamma."""
    if gamma is None:
        out = _mm(a, w) + residual.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(out_dtype or residual.dtype)
    out = _mm(a, w)
    if bias is not None:
        out = out + bias.float()
    return (residual.float() + out * gamma.float()).to(out_dtype
                                                       or residual.dtype)


def _split_qkv(qkv, heads, group_heads):
    """[B, S, 3W] in the grouped layout (``group_heads`` heads per group,
    each group q_g | k_g | v_g) -> q, k, v as fp32 [B, heads, S, d]."""
    b, s, w3 = qkv.shape
    d = w3 // 3 // heads
    g = group_heads or heads
    t = qkv.float().reshape(b, s, heads // g, 3, g, d)
    return (p.reshape(b, s, heads, d).transpose(1, 2) for p in t.unbind(3))


def attention_plain(qkv, heads: int, seq_len: int | None = None, *,
                    group_heads: int | None = None, q_scaled: bool = False,
                    normalize_p: bool = False, out_dtype=None):
    """qkv [B, S, 3W] (q | k | v, heads packed; or head-grouped, see
    ``attention``) -> [B, S, W] in ``out_dtype`` (default qkv's); keys at or
    beyond ``seq_len`` masked.  q is scaled before its rounding to the
    compute dtype (the TPU kernel's order) unless ``q_scaled`` says the qkv
    producer did it.  P is cast to the compute dtype before PV; the 1/sum
    applies to the output rows, as in the CUDA kernel, or to P before the
    cast with ``normalize_p``, as in the TPU kernels."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    cdt = qkv.dtype
    seq_len = s if seq_len is None else seq_len
    q, k, v = _split_qkv(qkv, heads, group_heads)
    if not q_scaled:
        q = (q * (1.0 / math.sqrt(d))).to(cdt).float()
    scores = q @ k.transpose(-1, -2)                          # [B, H, S, S]
    masked = torch.arange(s, device=qkv.device) >= seq_len
    scores = scores.masked_fill(masked, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    if normalize_p:
        o = (p / p.sum(-1, keepdim=True)).to(cdt).float() @ v
    else:
        o = (p.to(cdt).float() @ v) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(b, s, w).to(out_dtype or cdt)


_PLAIN = SimpleNamespace(ln_gemm=ln_gemm_plain, attention=attention_plain,
                         gemm_residual=gemm_residual_plain)
# K5's plain version normalises P before its cast, as the TPU kernel does
_PLAIN_SPLIT = SimpleNamespace(
    ln_gemm=ln_gemm_plain, gemm_residual=gemm_residual_plain,
    attention=partial(attention_plain, normalize_p=True))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_weight(w, k, n, device) -> int:
    """A bf16 [k, n] weight, contiguous or a column slice of a wider
    row-major matrix; returns its row stride."""
    if w.device != device:
        raise ValueError(f"w is on {w.device}, expected {device}")
    if w.dtype != torch.bfloat16:
        raise TypeError(f"w has dtype {w.dtype}, expected torch.bfloat16")
    if tuple(w.shape) != (k, n):
        raise ValueError(f"w has shape {tuple(w.shape)}, expected {(k, n)}")
    ldw = w.stride(0) if k > 1 else n
    if w.stride(1) != 1 or ldw < n or ldw % 8 or w.data_ptr() % 16:
        raise ValueError("w must be row-major with a row stride that is a "
                         "multiple of 8 and be 16-byte aligned")
    return ldw


def _vec_f32(t, n, device, name):
    t = t.to(device=device, dtype=torch.float32).contiguous()
    _check(name, t, torch.float32, (n,), device)
    return t


def ln_gemm(x, ln_scale, ln_bias, w, bias, *, act="none", eps=1e-5,
            q_scale=1.0, q_width=0):
    """x [M, K] (bf16 or fp32) -> act(LN(x) @ w + bias) [M, N] bf16, the
    q columns of each head group (``q_width`` wide, groups 3 q_width wide)
    times ``q_scale`` before the store.  ``w`` may be a column slice of a
    wider matrix.  Kernel ``ln_gemm``; plain version ``ln_gemm_plain`` on
    CPU tensors."""
    if not x.is_cuda:
        return ln_gemm_plain(x, ln_scale, ln_bias, w, bias, act=act, eps=eps,
                             q_scale=q_scale, q_width=q_width)
    m, k = x.shape
    n = w.shape[1]
    if k % 8 or n % 8 or q_width % 8:
        raise ValueError(f"ln_gemm needs K, N and q_width multiples of 8, "
                         f"got {k}, {n}, {q_width}")
    dev = x.device
    _check("x", x, (torch.bfloat16, torch.float32), (m, k), dev)
    ldw = _check_weight(w, k, n, dev)
    code = act_code(act)
    fused = _in_epilogue(code)
    if not fused and q_width:
        raise ValueError("the q-scale epilogue takes no gelu_poly form "
                         "past sig5")
    ln_scale = _vec_f32(ln_scale, k, dev, "ln_scale")
    ln_bias = _vec_f32(ln_bias, k, dev, "ln_bias")
    bias = _vec_f32(bias, n, dev, "bias")
    y = torch.empty((m, n), dtype=torch.bfloat16 if fused else torch.float32,
                    device=dev)
    xn = torch.empty((m, k), dtype=torch.bfloat16, device=dev)  # LN(x), bf16
    launch("aihab_ln_gemm", dev, x.data_ptr(), int(x.dtype == torch.float32),
           ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), ldw,
           bias.data_ptr(), y.data_ptr(), int(not fused), xn.data_ptr(), m,
           n, k, code if fused else 0, eps, q_scale, q_width,
           max(3 * q_width, 1))
    if not fused:
        y = act_pass(y, code, out_dtype=torch.bfloat16)
    ln_gemm.launches += 1
    return y


def gemm_residual(a, w, bias, residual, *, out_dtype=None, gamma=None):
    """a [M, K] bf16 @ w [K, N] bf16 + bias (or none) + residual [M, N]
    (bf16 or fp32) -> [M, N] in ``out_dtype`` (default: the residual's
    dtype); with ``gamma`` [N] (ConvNeXt's layer scale) residual + (a @ w +
    bias) * gamma.  ``w`` may be a column slice of a wider matrix.  Kernel
    ``gemm_residual``; plain version on CPU tensors."""
    out_dtype = out_dtype or residual.dtype
    if not a.is_cuda:
        return gemm_residual_plain(a, w, bias, residual, out_dtype=out_dtype,
                                   gamma=gamma)
    m, k = a.shape
    n = w.shape[1]
    if k % 8 or n % 8:
        raise ValueError(f"gemm_residual needs K, N multiples of 8, "
                         f"got {k}, {n}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not bf16/fp32")
    dev = a.device
    _check("a", a, torch.bfloat16, (m, k), dev)
    ldw = _check_weight(w, k, n, dev)
    _check("residual", residual, (torch.bfloat16, torch.float32), (m, n), dev)
    bias_ptr = None if bias is None else _vec_f32(bias, n, dev, "bias")
    gamma = None if gamma is None else _vec_f32(gamma, n, dev, "gamma")
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    launch("aihab_gemm_residual", dev, a.data_ptr(), w.data_ptr(), ldw,
           None if bias_ptr is None else bias_ptr.data_ptr(),
           None if gamma is None else gamma.data_ptr(),
           residual.data_ptr(), int(residual.dtype == torch.float32),
           y.data_ptr(), int(out_dtype == torch.float32), m, n, k)
    gemm_residual.launches += 1
    return y


def attention(qkv, heads: int, seq_len: int | None = None, *,
              group_heads: int | None = None, q_scaled: bool = False,
              out_dtype=None, normalize_p: bool = False):
    """qkv [B, S, 3W] bf16 -> masked multi-head attention [B, S, W] in
    ``out_dtype`` (default bf16; fp32 keeps the PV product unrounded, as the
    int8 blocks K12-K14 read it; keys >= ``seq_len`` masked).
    ``normalize_p`` (fp32 output only) casts P normalised to bf16, as the
    TPU kernels do, in a second pass over the keys; otherwise the 1/sum
    applies to the output rows.
    Layout: ``group_heads`` heads per group
    (default all: CLIP's packed q | k | v), each group's columns q_g | k_g
    | v_g.  ``q_scaled``: q already holds q / sqrt(d), rounded; otherwise
    the kernel scales the fp32 scores (exactly the plain version's
    rounded q / sqrt(d) when d = 64).  Kernel ``attention`` (head_dim in
    ``HEAD_DIMS``); plain version ``attention_plain`` on CPU tensors."""
    if not qkv.is_cuda:
        return attention_plain(qkv, heads, seq_len, group_heads=group_heads,
                               q_scaled=q_scaled, out_dtype=out_dtype,
                               normalize_p=normalize_p)
    out_dtype = out_dtype or torch.bfloat16
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // heads
    g = group_heads or heads
    seq_len = s if seq_len is None else seq_len
    if w3 % 3 or w != heads * d or d not in HEAD_DIMS:
        raise ValueError(f"attention kernel needs head_dim in {HEAD_DIMS}: "
                         f"width {w} over {heads} heads")
    if heads % g:
        raise ValueError(f"group of {g} heads does not divide {heads}")
    if not 1 <= seq_len <= s:
        raise ValueError(f"seq_len {seq_len} outside [1, {s}]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype} not bf16/fp32")
    if normalize_p and out_dtype != torch.float32:
        raise ValueError("normalize_p needs the fp32 output")
    _check("qkv", qkv, torch.bfloat16, (b, s, w3), qkv.device)
    out = torch.empty((b, s, w), dtype=out_dtype, device=qkv.device)
    launch("aihab_attention", qkv.device, qkv.data_ptr(), out.data_ptr(),
           b, s, seq_len, heads, g, d, 1.0 if q_scaled else 1.0 / math.sqrt(d),
           int(out_dtype == torch.float32), int(normalize_p))
    attention.launches += 1
    return out


_KERNELS = SimpleNamespace(ln_gemm=ln_gemm, attention=attention,
                           gemm_residual=gemm_residual)


# ---------------------------------------------------------------------------
# the block compositions, shared by the kernel and plain paths
# ---------------------------------------------------------------------------


def _attn_half(ops, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, heads,
               seq_len, out_dtype):
    b, s, w = x.shape
    x2 = x.reshape(b * s, w)
    qkv = ops.ln_gemm(x2, ln_scale, ln_bias, w_qkv, b_qkv)
    attn = ops.attention(qkv.reshape(b, s, 3 * w), heads, seq_len)
    return ops.gemm_residual(attn.reshape(b * s, w), w_out, b_out, x2,
                             out_dtype=out_dtype)          # [B*S, W]


def _mlp_half(ops, x2, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, act,
              out_dtype):
    h = ops.ln_gemm(x2, ln_scale, ln_bias, w_fc, b_fc, act=act)
    return ops.gemm_residual(h, w_proj, b_proj, x2, out_dtype=out_dtype)


def _full_block(ops, x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out,
                ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj, heads, act):
    b, s, w = x.shape
    y1 = _attn_half(ops, x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out,
                    heads, s, torch.float32)     # fp32 residual stream
    out = _mlp_half(ops, y1, ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj,
                    act, x.dtype)
    return out.reshape(b, s, w)


def _attn_split(ops, x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias, heads,
                group_heads, seq_len, ln_eps):
    """K5 over the flat layouts: w_qkv [W, G*3gD], w_out [G*gD, W]."""
    b, s, w = x.shape
    d = w // heads
    x2 = x.reshape(b * s, w)
    qkv = ops.ln_gemm(x2, ln_scale, ln_bias, w_qkv, b_qkv, eps=ln_eps,
                      q_scale=1.0 / math.sqrt(d), q_width=group_heads * d)
    attn = ops.attention(qkv.reshape(b, s, 3 * w), heads, seq_len,
                         group_heads=group_heads, q_scaled=True)
    out = ops.gemm_residual(attn.reshape(b * s, w), w_out, b_out, x2,
                            out_dtype=x.dtype)
    return out.reshape(x.shape)


def _mlp_split(ops, x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj,
               n_chunks, act, ln_eps, f32_partial):
    ch = w_fc.shape[1] // n_chunks
    part_dt = torch.float32 if f32_partial else x.dtype
    acc = x
    for c in range(n_chunks):
        cols = slice(c * ch, (c + 1) * ch)
        h = ops.ln_gemm(x, ln_scale, ln_bias, w_fc[:, cols], b_fc[cols],
                        act=act, eps=ln_eps)
        acc = ops.gemm_residual(
            h, w_proj[cols], b_proj if c == 0 else None, acc,
            out_dtype=x.dtype if c == n_chunks - 1 else part_dt)
    return acc


def _check_act(act):
    if act not in ACTS or act == "none":
        raise ValueError(f"unknown block activation {act!r}")


def full_block_fused_plain(x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out,
                           b_out, ln2_scale, ln2_bias, w_fc, b_fc, w_proj,
                           b_proj, heads: int, *, mlp_chunks: int = 1,
                           act: str = "quick_gelu"):
    """Plain version of ``full_block_fused`` (same signature)."""
    return _full_block(_PLAIN, x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out,
                       b_out, ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj,
                       heads, act)


def full_block_fused(x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out, b_out,
                     ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj,
                     heads: int, *, mlp_chunks: int = 1,
                     act: str = "quick_gelu"):
    """x [B, S, W] -> the whole pre-LN CLIP block (K1): LN1 -> QKV -> MHA ->
    out-proj + x -> LN2 -> c_fc -> act -> c_proj + y1, y1 in fp32.

    ``mlp_chunks`` only has to divide the hidden width: the TPU kernel
    chunked the hidden dim to bound VMEM liveness, while the c_proj kernel
    here sums the whole hidden dim in one k loop."""
    _check_act(act)
    if w_fc.shape[1] % mlp_chunks:
        raise ValueError(f"mlp_chunks {mlp_chunks} does not divide hidden "
                         f"{w_fc.shape[1]}")
    if not x.is_cuda:
        return full_block_fused_plain(x, ln1_scale, ln1_bias, w_qkv, b_qkv,
                                      w_out, b_out, ln2_scale, ln2_bias,
                                      w_fc, b_fc, w_proj, b_proj, heads,
                                      act=act)
    out = _full_block(_KERNELS, x, ln1_scale, ln1_bias, w_qkv, b_qkv, w_out,
                      b_out, ln2_scale, ln2_bias, w_fc, b_fc, w_proj, b_proj,
                      heads, act)
    full_block_fused.launches += 1
    return out


def attn_block_fused_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                           heads: int, *, padded_io: bool = False,
                           seq_len: int | None = None):
    """Plain version of ``attn_block_fused`` (same signature)."""
    seq_len = _attn_seq_len(x, padded_io, seq_len)
    out = _attn_half(_PLAIN, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                     b_out, heads, seq_len, x.dtype)
    return out.reshape(x.shape)


def _attn_seq_len(x, padded_io, seq_len):
    if padded_io:
        if seq_len is None:
            raise ValueError("padded_io=True requires seq_len")
        return seq_len
    return x.shape[1]


def attn_block_fused(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                     heads: int, *, padded_io: bool = False,
                     seq_len: int | None = None):
    """x [B, S, W] -> x + out_proj(MHA(LN(x))) (K2), output in x's dtype.

    ``padded_io``: x arrives padded past the real sequence ``seq_len``;
    keys at or beyond it are masked and the padded result is returned
    whole (padded rows hold row-local values that no valid row reads).
    No padding is needed otherwise: the kernels mask their ragged edges."""
    if not x.is_cuda:
        return attn_block_fused_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                      w_out, b_out, heads,
                                      padded_io=padded_io, seq_len=seq_len)
    seq_len = _attn_seq_len(x, padded_io, seq_len)
    out = _attn_half(_KERNELS, x, ln_scale, ln_bias, w_qkv, b_qkv, w_out,
                     b_out, heads, seq_len, x.dtype)
    attn_block_fused.launches += 1
    return out.reshape(x.shape)


def mlp_block_fused_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj,
                          *, act: str = "quick_gelu"):
    """Plain version of ``mlp_block_fused`` (same signature)."""
    return _mlp_half(_PLAIN, x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                     b_proj, act, x.dtype)


def mlp_block_fused(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj,
                    *, act: str = "quick_gelu"):
    """x [M, W] -> x + c_proj(act(c_fc(LN(x)))) (K3), over rows."""
    _check_act(act)
    if not x.is_cuda:
        return mlp_block_fused_plain(x, ln_scale, ln_bias, w_fc, b_fc,
                                     w_proj, b_proj, act=act)
    out = _mlp_half(_KERNELS, x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                    b_proj, act, x.dtype)
    mlp_block_fused.launches += 1
    return out


def regroup_attn_weights_f(wqkv, b_qkv, wout, heads: int, n_groups: int):
    """Packed [W, 3W] q|k|v + [W, W] out-proj -> the per-head-group tensors
    of ``attn_block_split``: ``wqkv_g`` [G, W, 3gD] (group j's columns
    q_j | k_j | v_j), ``b_qkv_g`` [G, 3gD] fp32, ``wout_g`` [G, gD, W]
    (block_kernel.py:1122)."""
    if heads % n_groups:
        raise ValueError(f"n_groups {n_groups} must divide heads {heads}")
    w = wqkv.shape[0]
    gd = w // n_groups                 # g heads of width D per group
    wq = wqkv.reshape(w, 3, n_groups, gd).permute(2, 0, 1, 3)
    bq = b_qkv.float().reshape(3, n_groups, gd).transpose(0, 1)
    return (wq.reshape(n_groups, w, 3 * gd).contiguous(),
            bq.reshape(n_groups, 3 * gd).contiguous(),
            wout.reshape(n_groups, gd, -1).contiguous())


def _split_layouts(x, wqkv_g, b_qkv_g, wout_g, heads, n_groups):
    """JAX-layout ([G, W, 3gD]) or flat ([W, G*3gD]) grouped weights ->
    the flat operands of one ln_gemm and one gemm_residual."""
    if heads % n_groups:
        raise ValueError(f"n_groups {n_groups} must divide heads {heads} "
                         "(a floored group size would silently drop heads)")
    w = x.shape[-1]
    if wqkv_g.dim() == 3:
        wqkv_g = wqkv_g.permute(1, 0, 2).reshape(w, -1)
    return wqkv_g, b_qkv_g.reshape(-1), wout_g.reshape(-1, w)


def _split_seq_len(x, padded_io, seq_len):
    if padded_io and x.shape[1] % 16:
        raise ValueError(f"padded_io input S={x.shape[1]} not a multiple "
                         "of 16")
    return _attn_seq_len(x, padded_io, seq_len)


def attn_block_split_plain(x, wqkv_g, b_qkv_g, wout_g, b_out, ln_scale,
                           ln_bias, heads: int, n_groups: int,
                           ln_eps: float = 1e-5, padded_io: bool = False,
                           seq_len: int | None = None):
    """Plain version of ``attn_block_split`` (same signature)."""
    seq_len = _split_seq_len(x, padded_io, seq_len)
    wqkv, bqkv, wout = _split_layouts(x, wqkv_g, b_qkv_g, wout_g, heads,
                                      n_groups)
    return _attn_split(_PLAIN_SPLIT, x, wqkv, bqkv, wout, b_out, ln_scale,
                       ln_bias, heads, heads // n_groups, seq_len, ln_eps)


def attn_block_split(x, wqkv_g, b_qkv_g, wout_g, b_out, ln_scale, ln_bias,
                     heads: int, n_groups: int, ln_eps: float = 1e-5,
                     padded_io: bool = False, seq_len: int | None = None):
    """x [B, S, W] -> x + out_proj(MHA(LN(x))) over ``n_groups`` head
    groups (K5), output in x's dtype.

    ``wqkv_g`` is the JAX layout [G, W, 3gD] (``regroup_attn_weights_f``)
    or the same columns laid out once as one [W, G*3gD] matrix (the fast
    SigLIP pack), ``b_qkv_g`` [G, 3gD], ``wout_g`` [G, gD, W].  q is scaled
    by 1/sqrt(d) in fp32 before its bf16 rounding and P is normalised
    before its cast, as in the TPU kernel; the group partials of the
    out-proj sum in fp32.  ``padded_io``/``seq_len``: see
    ``attn_block_fused``."""
    if not x.is_cuda:
        return attn_block_split_plain(x, wqkv_g, b_qkv_g, wout_g, b_out,
                                      ln_scale, ln_bias, heads, n_groups,
                                      ln_eps, padded_io, seq_len)
    seq_len = _split_seq_len(x, padded_io, seq_len)
    wqkv, bqkv, wout = _split_layouts(x, wqkv_g, b_qkv_g, wout_g, heads,
                                      n_groups)
    out = _attn_split(_KERNELS, x, wqkv, bqkv, wout, b_out, ln_scale,
                      ln_bias, heads, heads // n_groups, seq_len, ln_eps)
    attn_block_split.launches += 1
    return out


def _check_split_mlp(w_fc, n_chunks, act):
    _check_act(act)
    if n_chunks < 1 or w_fc.shape[1] % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} does not divide hidden "
                         f"{w_fc.shape[1]}")


def mlp_block_split_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj,
                          *, n_chunks: int = 2, act: str = "quick_gelu",
                          ln_eps: float = 1e-5, tile_m: int = 0,
                          f32_partial: bool = False):
    """Plain version of ``mlp_block_split`` (same signature)."""
    del tile_m
    _check_split_mlp(w_fc, n_chunks, act)
    return _mlp_split(_PLAIN, x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                      b_proj, n_chunks, act, ln_eps, f32_partial)


def mlp_block_split(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj,
                    *, n_chunks: int = 2, act: str = "quick_gelu",
                    ln_eps: float = 1e-5, tile_m: int = 0,
                    f32_partial: bool = False):
    """x [M, W] -> x + c_proj(act(c_fc(LN(x)))) with the hidden dim in
    ``n_chunks`` chunks (K4).  The running partial crosses each chunk
    boundary in x's dtype, or fp32 with ``f32_partial``; chunk 0 adds
    ``b_proj`` and x.  ``tile_m`` was the TPU kernel's row tile: accepted
    and ignored (the GEMMs tile their rows themselves)."""
    _check_split_mlp(w_fc, n_chunks, act)
    if not x.is_cuda:
        return mlp_block_split_plain(x, ln_scale, ln_bias, w_fc, b_fc,
                                     w_proj, b_proj, n_chunks=n_chunks,
                                     act=act, ln_eps=ln_eps,
                                     f32_partial=f32_partial)
    out = _mlp_split(_KERNELS, x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                     b_proj, n_chunks, act, ln_eps, f32_partial)
    mlp_block_split.launches += 1
    return out


def _convnext_mlp(ops, y, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                  n_chunks, act, ln_eps):
    ch = w1.shape[1] // n_chunks
    acc = residual
    for c in range(n_chunks):
        cols = slice(c * ch, (c + 1) * ch)
        h = ops.ln_gemm(y, ln_scale, ln_bias, w1[:, cols], b1[cols], act=act,
                        eps=ln_eps)
        acc = ops.gemm_residual(h, w2[cols], b2 if c == 0 else None, acc,
                                out_dtype=y.dtype, gamma=gamma)
    return acc


def _convnext_chunks(w1, n_chunks, act) -> int:
    """``n_chunks`` 0 (auto) -> 1: the TPU rule split the hidden dim to fit
    a weight pair in VMEM (block_kernel.py:708-712), while these GEMMs
    stream weight tiles through shared memory."""
    _check_act(act)
    n_chunks = n_chunks or 1
    if n_chunks < 1 or w1.shape[1] % n_chunks:
        raise ValueError(f"n_chunks {n_chunks} does not divide hidden "
                         f"{w1.shape[1]}")
    return n_chunks


def convnext_mlp_block_plain(y, residual, ln_scale, ln_bias, w1, b1, w2, b2,
                             gamma, *, act: str = "gelu_poly",
                             ln_eps: float = 1e-6, tile_m: int = 0,
                             n_chunks: int = 0):
    """Plain version of ``convnext_mlp_block`` (same signature)."""
    del tile_m
    n_chunks = _convnext_chunks(w1, n_chunks, act)
    return _convnext_mlp(_PLAIN, y, residual, ln_scale, ln_bias, w1, b1, w2,
                         b2, gamma, n_chunks, act, ln_eps)


def convnext_mlp_block(y, residual, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                       *, act: str = "gelu_poly", ln_eps: float = 1e-6,
                       tile_m: int = 0, n_chunks: int = 0):
    """The ConvNeXt block past its depthwise conv (K7): ``residual + gamma *
    fc2(act(fc1(LN(y))))`` over [M, C] rows, y the dwconv output and
    ``residual`` the block input, output in y's dtype.  ``w1`` [C, H] and
    ``w2`` [H, C] in y's dtype (bf16 on the card); LN, b1, b2 and gamma
    fp32.  The hidden h is rounded to y's dtype before fc2, and with
    ``n_chunks`` > 1 the hidden dim runs in chunks whose running sum crosses
    each boundary in y's dtype (chunk 0: res + (p_0 + b2) * gamma; chunk
    c: acc + p_c * gamma).  ``n_chunks`` 0 (auto) is one chunk here;
    ``tile_m`` was the TPU kernel's row tile: accepted and ignored."""
    if not y.is_cuda:
        return convnext_mlp_block_plain(y, residual, ln_scale, ln_bias, w1,
                                        b1, w2, b2, gamma, act=act,
                                        ln_eps=ln_eps, n_chunks=n_chunks)
    n_chunks = _convnext_chunks(w1, n_chunks, act)
    out = _convnext_mlp(_KERNELS, y, residual, ln_scale, ln_bias, w1, b1, w2,
                        b2, gamma, n_chunks, act, ln_eps)
    convnext_mlp_block.launches += 1
    return out


# ---------------------------------------------------------------------------
# K17: the differentiable MLP block (QuickGELU only, as in JAX)
# ---------------------------------------------------------------------------


def _quick_gelu_grad(h):
    """d/dh of h * sigmoid(1.702 h) on fp32 ``h``
    (``block_kernel.py:_quick_gelu_grad_f32``)."""
    s = torch.sigmoid(1.702 * h)
    return s * (1.0 + 1.702 * h * (1.0 - s))


def _xhat(x, eps=1e-5):
    """(x - mean) * rstd and rstd of fp32 rows, two-pass statistics."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    return (xf - mean) * rstd, rstd


def mlp_block_train_fwd_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                              b_proj):
    """Plain version of ``mlp_block_train_fwd`` (``_mlp_fwd_train_kernel``):
    (y, h_pre) in x's dtype; h is quick_gelu of the fp32 pre-activation,
    rounded to x's dtype before c_proj."""
    h_pre = _mm(_ln_f32(x, ln_scale, ln_bias).to(x.dtype), w_fc) \
        + b_fc.float()
    h = act_f32(h_pre, "quick_gelu").to(x.dtype)
    y = (_mm(h, w_proj) + b_proj.float()) + x.float()
    return y.to(x.dtype), h_pre.to(x.dtype)


def mlp_block_train_bwd_plain(x, h_pre, dy, ln_scale, w_fc, w_proj):
    """Plain version of ``mlp_block_train_bwd`` (``_mlp_bwd_train_kernel``):
    (dx, dh_pre, dln) in x's dtype; dln's fp32 value feeds dx."""
    dh_pre = _mm(dy, w_proj.t()) * _quick_gelu_grad(h_pre.float())
    dln = _mm(dh_pre.to(x.dtype), w_fc.t())
    xhat, rstd = _xhat(x)
    dxhat = dln * ln_scale.float()
    dx = (dxhat - dxhat.mean(-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(-1, keepdim=True)) * rstd
    return ((dy.float() + dx).to(x.dtype), dh_pre.to(x.dtype),
            dln.to(x.dtype))


def _train_shapes(x, w_fc, w_proj):
    m, w = x.shape
    hidden = w_fc.shape[1]
    if w % 8 or hidden % 8:
        raise ValueError(f"mlp_block_train's kernels need W and the hidden "
                         f"width multiples of 8, got {w}, {hidden}")
    if tuple(w_proj.shape) != (hidden, w):
        raise ValueError(f"w_proj has shape {tuple(w_proj.shape)}, expected "
                         f"{(hidden, w)}")
    return m, w, hidden


def mlp_block_train_fwd(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """K17's forward: x [M, W] -> (y = x + c_proj(quick_gelu(c_fc(LN x))),
    h_pre = c_fc(LN x)), both bf16.  ``w_fc`` [W, H] and ``w_proj`` [H, W]
    (JAX's layout; a transposed view of torch's weights is copied once into
    it).  Kernel ``mlp_train_fwd`` (``ln_gemm`` storing h_pre beside h, then
    ``gemm_residual``); plain version on CPU tensors."""
    if not x.is_cuda:
        return mlp_block_train_fwd_plain(x, ln_scale, ln_bias, w_fc, b_fc,
                                         w_proj, b_proj)
    m, w, hidden = _train_shapes(x, w_fc, w_proj)
    dev = x.device
    _check("x", x, torch.bfloat16, (m, w), dev)
    w_fc, w_proj = w_fc.contiguous(), w_proj.contiguous()
    _check_weight(w_fc, w, hidden, dev)
    _check_weight(w_proj, hidden, w, dev)
    args = [_vec_f32(t, n, dev, name) for t, n, name in (
        (ln_scale, w, "ln_scale"), (ln_bias, w, "ln_bias"),
        (b_fc, hidden, "b_fc"), (b_proj, w, "b_proj"))]
    y = torch.empty((m, w), dtype=torch.bfloat16, device=dev)
    h_pre = torch.empty((m, hidden), dtype=torch.bfloat16, device=dev)
    h = torch.empty_like(h_pre)
    xn = torch.empty((m, w), dtype=torch.bfloat16, device=dev)  # LN(x), bf16
    launch("aihab_mlp_train_fwd", dev, x.data_ptr(), args[0].data_ptr(),
           args[1].data_ptr(), w_fc.data_ptr(), args[2].data_ptr(),
           w_proj.data_ptr(), args[3].data_ptr(), y.data_ptr(),
           h_pre.data_ptr(), h.data_ptr(), xn.data_ptr(), m, w, hidden,
           1e-5)
    mlp_block_train_fwd.launches += 1
    return y, h_pre


def mlp_block_train_bwd(x, h_pre, dy, ln_scale, w_fc, w_proj):
    """K17's backward dx chain: (dx, dh_pre, dln), bf16, for x, dy [M, W]
    and h_pre [M, H] bf16.  It reads ``w_proj.t()`` and ``w_fc.t()``
    row-major: torch's ``c_proj.weight`` and ``c_fc.weight`` as stored, so
    the transposed views ``vit_encode_train`` passes cost no copy.  Kernel
    ``mlp_train_bwd``; plain version on CPU tensors."""
    if not x.is_cuda:
        return mlp_block_train_bwd_plain(x, h_pre, dy, ln_scale, w_fc,
                                         w_proj)
    m, w, hidden = _train_shapes(x, w_fc, w_proj)
    dev = x.device
    for name, t, shape in (("x", x, (m, w)), ("dy", dy, (m, w)),
                           ("h_pre", h_pre, (m, hidden))):
        _check(name, t, torch.bfloat16, shape, dev)
    w_fc_t, w_proj_t = w_fc.t().contiguous(), w_proj.t().contiguous()
    _check_weight(w_fc_t, hidden, w, dev)
    _check_weight(w_proj_t, w, hidden, dev)
    ln_scale = _vec_f32(ln_scale, w, dev, "ln_scale")
    dx = torch.empty((m, w), dtype=torch.bfloat16, device=dev)
    dh_pre = torch.empty((m, hidden), dtype=torch.bfloat16, device=dev)
    dln = torch.empty((m, w), dtype=torch.float32, device=dev)
    dln16 = torch.empty((m, w), dtype=torch.bfloat16, device=dev)
    launch("aihab_mlp_train_bwd", dev, x.data_ptr(), h_pre.data_ptr(),
           dy.data_ptr(), ln_scale.data_ptr(), w_fc_t.data_ptr(),
           w_proj_t.data_ptr(), dx.data_ptr(), dh_pre.data_ptr(),
           dln.data_ptr(), dln16.data_ptr(), m, w, hidden, 1e-5)
    mlp_block_train_bwd.launches += 1
    return dx, dh_pre, dln16


_TRAIN_KERNELS = SimpleNamespace(fwd=mlp_block_train_fwd,
                                 bwd=mlp_block_train_bwd)
_TRAIN_PLAIN = SimpleNamespace(fwd=mlp_block_train_fwd_plain,
                               bwd=mlp_block_train_bwd_plain)


class _MLPBlockTrain(torch.autograd.Function):
    """JAX's ``_mlp_block_train`` custom VJP (``block_kernel.py:225-342``)
    over the forward and backward in ``ops``."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, ops):
        y, h_pre = ops.fwd(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj)
        ctx.save_for_backward(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                              b_proj, h_pre)
        ctx.ops = ops
        return y

    @staticmethod
    def backward(ctx, dy):
        x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, h_pre = \
            ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx, dh_pre, dln = ctx.ops.bwd(x, h_pre, dy, ln_scale, w_fc, w_proj)
        # the parameter gradients over the emitted tensors (:320-338)
        xhat, _ = _xhat(x)
        ln2 = xhat * ln_scale.float() + ln_bias.float()
        dln = dln.float()
        h = act_f32(h_pre.float(), "quick_gelu").to(x.dtype)
        return (dx, (dln * xhat).sum(0).to(ln_scale.dtype),
                dln.sum(0).to(ln_bias.dtype),
                (ln2.to(x.dtype).t() @ dh_pre).to(w_fc.dtype),
                dh_pre.float().sum(0).to(b_fc.dtype),
                (h.t() @ dy).to(w_proj.dtype),
                dy.float().sum(0).to(b_proj.dtype), None)


def mlp_block_train(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """Differentiable x + c_proj(QuickGELU(c_fc(LN(x)))) over x [M, W]
    (K17): the forward through ``mlp_block_train_fwd``, the backward's dx
    chain through ``mlp_block_train_bwd`` and the parameter gradients as
    plain products and sums over what they emit.  QuickGELU whatever the
    tower's activation, as in JAX; LN eps 1e-5; ``w_fc`` [W, H], ``w_proj``
    [H, W]."""
    return _MLPBlockTrain.apply(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                                b_proj, _TRAIN_KERNELS)


def mlp_block_train_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """``mlp_block_train`` over the plain forward and backward, on any
    device (same signature)."""
    return _MLPBlockTrain.apply(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                                b_proj, _TRAIN_PLAIN)


COUNTED = (ln_gemm, attention, gemm_residual, full_block_fused,
           attn_block_fused, mlp_block_fused, attn_block_split,
           mlp_block_split, convnext_mlp_block, mlp_block_train_fwd,
           mlp_block_train_bwd)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
