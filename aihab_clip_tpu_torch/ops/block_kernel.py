"""Whole-block transformer kernels on Hopper, with their plain versions.

Ports of ``aihab_clip_tpu/ops/block_kernel.py`` (Pallas, TPU):

  * ``full_block_fused`` (K1, CLIP's main path)  x -> the whole pre-LN block
  * ``attn_block_fused`` (K2)                 x -> x + out(MHA(LN1 x))
  * ``mlp_block_fused``  (K3)                 x -> x + c_proj(act(c_fc(LN2 x)))
  * ``attn_block_split`` (K5, SigLIP's path)  K2 over head groups
  * ``mlp_block_split``  (K4, SigLIP's path)  K3 with the hidden dim in chunks

On the TPU each is one program per image (or row tile) with its weights
resident in VMEM.  On the H100 each is a composition of three hand-written
CUDA kernels (``csrc/block_kernels.cu``, whose header gives the design and
the bound):

  * ``ln_gemm``        fp32 LN prologue -> bf16 GEMM -> bias [+ act]
                       [* q-scale on the q columns]
  * ``attention``      masked multi-head softmax(q k^T / sqrt(d)) v,
                       head_dim 64 or 72, packed or head-grouped qkv
  * ``gemm_residual``  bf16 GEMM -> bias + residual

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
place through the GEMM's row stride.

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
from functools import partial
from types import SimpleNamespace

import torch

ACTS = {"none": 0, "quick_gelu": 1, "gelu_tanh": 2, "gelu_poly": 3}
# the attention kernel's head widths: CLIP ViT-B/L/H (64), SigLIP SO400M (72)
HEAD_DIMS = (64, 72)

# deg-5 sigmoid-poly exact-GELU fit (block_kernel.py:439, the JAX default)
_GELU_SIG5_COEF = (1.5953873, 0.07364605, -6.3791875e-4)


# ---------------------------------------------------------------------------
# plain versions (PyTorch)
# ---------------------------------------------------------------------------


def act_f32(h: torch.Tensor, act: str) -> torch.Tensor:
    """The kernels' activations on fp32 ``h`` (block_kernel.py:_act_f32)."""
    if act == "none":
        return h
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(h, approximate="tanh")
    if act == "gelu_poly":
        hc = h.clamp(-7.5, 7.5)
        u = hc * hc
        c1, c3, c5 = _GELU_SIG5_COEF
        return h * torch.sigmoid(hc * (c1 + u * (c3 + u * c5)))
    raise ValueError(f"unknown activation {act!r}")


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


def gemm_residual_plain(a, w, bias, residual, *, out_dtype=None):
    """a @ w [+ bias] + residual, summed in fp32, stored as ``out_dtype``."""
    out = _mm(a, w) + residual.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or residual.dtype)


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
                    normalize_p: bool = False):
    """qkv [B, S, 3W] (q | k | v, heads packed; or head-grouped, see
    ``attention``) -> [B, S, W]; keys at or beyond ``seq_len`` masked.
    q is scaled before its rounding to the compute dtype (the TPU
    kernel's order) unless ``q_scaled`` says the qkv producer did it.  P is
    cast to the compute dtype before PV; the 1/sum applies to the output
    rows, as in the CUDA kernel, or to P before the cast with
    ``normalize_p``, as in the TPU kernels."""
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
    return o.transpose(1, 2).reshape(b, s, w).to(cdt)


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


def _launch(fn, device, *args):
    from ._build import library

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err}")


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
    ln_scale = _vec_f32(ln_scale, k, dev, "ln_scale")
    ln_bias = _vec_f32(ln_bias, k, dev, "ln_bias")
    bias = _vec_f32(bias, n, dev, "bias")
    y = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((m, 2), dtype=torch.float32, device=dev)  # mean, rstd
    _launch("aihab_ln_gemm", dev, x.data_ptr(), int(x.dtype == torch.float32),
            ln_scale.data_ptr(), ln_bias.data_ptr(), w.data_ptr(), ldw,
            bias.data_ptr(), y.data_ptr(), stats.data_ptr(), m, n, k,
            ACTS[act], eps, q_scale, q_width, max(3 * q_width, 1))
    ln_gemm.launches += 1
    return y


def gemm_residual(a, w, bias, residual, *, out_dtype=None):
    """a [M, K] bf16 @ w [K, N] bf16 + bias (or none) + residual [M, N]
    (bf16 or fp32) -> [M, N] in ``out_dtype`` (default: the residual's
    dtype).  ``w`` may be a column slice of a wider matrix.  Kernel
    ``gemm_residual``; plain version on CPU tensors."""
    out_dtype = out_dtype or residual.dtype
    if not a.is_cuda:
        return gemm_residual_plain(a, w, bias, residual, out_dtype=out_dtype)
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
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    _launch("aihab_gemm_residual", dev, a.data_ptr(), w.data_ptr(), ldw,
            None if bias_ptr is None else bias_ptr.data_ptr(),
            residual.data_ptr(), int(residual.dtype == torch.float32),
            y.data_ptr(), int(out_dtype == torch.float32), m, n, k)
    gemm_residual.launches += 1
    return y


def attention(qkv, heads: int, seq_len: int | None = None, *,
              group_heads: int | None = None, q_scaled: bool = False):
    """qkv [B, S, 3W] bf16 -> masked multi-head attention [B, S, W] bf16
    (keys >= ``seq_len`` masked).  Layout: ``group_heads`` heads per group
    (default all: CLIP's packed q | k | v), each group's columns q_g | k_g
    | v_g.  ``q_scaled``: q already holds q / sqrt(d), rounded; otherwise
    the kernel scales the fp32 scores (exactly the plain version's
    rounded q / sqrt(d) when d = 64).  Kernel ``attention`` (head_dim 64 or
    72); plain version ``attention_plain`` on CPU tensors."""
    if not qkv.is_cuda:
        return attention_plain(qkv, heads, seq_len, group_heads=group_heads,
                               q_scaled=q_scaled)
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
    _check("qkv", qkv, torch.bfloat16, (b, s, w3), qkv.device)
    out = torch.empty((b, s, w), dtype=torch.bfloat16, device=qkv.device)
    _launch("aihab_attention", qkv.device, qkv.data_ptr(), out.data_ptr(),
            b, s, seq_len, heads, g, d, 1.0 if q_scaled else 1.0 / math.sqrt(d))
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


COUNTED = (ln_gemm, attention, gemm_residual, full_block_fused,
           attn_block_fused, mlp_block_fused, attn_block_split,
           mlp_block_split)
for _fn in COUNTED:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}
