"""The int8 GEMM's quantized output (``int8_gemm(..., out_dtype=torch.int8)``,
the requantize that K9, K11, K14's c_fc and K15 take from the GEMM's
epilogue), on the CPU: its plain version is ``row_quant`` of the fp32 output
bit for bit; the compositions call it and no ``row_quant`` of an fp32 GEMM
output; through it they match the Pallas kernels in interpret mode; and
what the kernel's form refuses.  The kernel against its plain
version on a card: ``tests/test_torch_cuda.py``."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.ops import quant as jax_quant
from aihab_clip_tpu.ops import quant_matmul as jax_qm

from aihab_clip_tpu_torch.ops import quant_matmul as qm

ACTS = ["none", "quick_gelu", "gelu_tanh", "gelu_poly"]


@pytest.fixture(autouse=True)
def _default_gelu_poly(monkeypatch):
    monkeypatch.delenv("AIHAB_ERF_IMPL", raising=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_quant.py`` pins it: CPU
    sums run in an order that depends on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return n


def _weights(n, k, cols):
    w8, ws = jax_quant.quantize_weight(jnp.asarray(n(k, cols, scale=k ** -0.5)))
    return np.asarray(w8), np.asarray(ws)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _gemm_operands(seed, m, k, n_cols):
    gen = torch.Generator().manual_seed(seed)
    a8 = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    wt = torch.randint(-127, 128, (n_cols, k), generator=gen, dtype=torch.int8)
    sa = torch.rand(m, 1, generator=gen) * 0.02 + 1e-3
    ws = torch.rand(n_cols, generator=gen) * 0.02 + 1e-3
    bias = torch.randn(n_cols, generator=gen) * 0.1
    return a8, sa, wt, ws, bias


# (M, K, N, group, group_pad): one group; a ragged N (8 x 43, as the
# smoke's 300 x 1152 x 344 cases); 2 chunks of 128; 2 chunks of 168 padded
# to 192
SHAPES = [(64, 128, 256, 0, 0), (300, 128, 344, 0, 0), (48, 64, 256, 128, 128),
          (40, 96, 336, 168, 192)]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,k,n,group,pad", SHAPES)
def test_quantized_output_is_row_quant_of_fp32(m, k, n, group, pad, act):
    """(codes, scales) = row_quant_plain(int8_gemm_plain(fp32)) bit for bit,
    with no residual or gamma; the wrapper on CPU tensors returns the same."""
    args = _gemm_operands(m + n, m, k, n)
    kw = dict(act=act, out_group=group, out_group_pad=pad)
    q, s = qm.int8_gemm_plain(*args, out_dtype=torch.int8, **kw)
    y = qm.int8_gemm_plain(*args, act=act, out_dtype=torch.float32)
    want_q, want_s = qm.row_quant_plain(y, group=group, group_pad=pad)
    kg = group or n
    assert q.dtype == torch.int8 and q.shape == (m, n // kg * max(pad, kg))
    assert s.shape == (m, n // kg)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    if pad > kg:
        assert not q.reshape(m, n // kg, pad)[..., kg:].any()
    qm.reset_launch_counts()
    got_q, got_s = qm.int8_gemm(*args, out_dtype=torch.int8, **kw)
    assert torch.equal(got_q, q) and torch.equal(got_s, s)
    assert qm.launch_counts()["int8_gemm"] == 0     # CPU tensors: no launch


def _recording_ops():
    """The plain ops, recording each int8_gemm's out_dtype and whether a
    row_quant reads an int8_gemm's output."""
    calls, outs = [], []

    def int8_gemm(*a, **kw):
        calls.append(("int8_gemm", kw.get("out_dtype")))
        out = qm.int8_gemm_plain(*a, **kw)
        outs.append(out)
        return out

    def row_quant(x, *a, **kw):
        calls.append(("row_quant", any(x is o for o in outs)))
        return qm.row_quant_plain(x, *a, **kw)

    return calls, SimpleNamespace(row_quant=row_quant, int8_gemm=int8_gemm,
                                  attention=qm._PLAIN.attention)


def _block_args(seed, w, hidden):
    n = _rng(seed)
    wq, sq = _weights(n, w, 3 * w)
    wo, so = _weights(n, w, w)
    w1, s1 = _weights(n, w, hidden)
    w2, s2 = _weights(n, hidden, w)
    return [wq, sq, n(3 * w, scale=0.1), wo, so, n(w, scale=0.1),
            1 + n(w, scale=0.1), n(w, scale=0.1), w1, s1, n(hidden, scale=0.1),
            w2, s2, n(w, scale=0.1), 1 + n(w, scale=0.1), n(w, scale=0.1)]


def _close(got, ref, dtype):
    """fp32 within 1e-5, bf16 within 2 bf16 ulps of max|ref| (the gates of
    ``tests/test_torch_quant_vit.py``: a last-bit difference of the LN or
    the activation can flip one code, which moves its row by one code step
    times a weight)."""
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    atol = 1e-5 if dtype == "float32" else 2 * 2 ** -8 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K9", "K11", "K14", "K14 2 chunks", "K15"])
def test_compositions_take_the_quantized_output(kernel, dtype):
    """K9, K11, K14 (1 and 2 hidden chunks) and K15 requantize their hidden
    row through the quantized output (no row_quant of an fp32 GEMM output)
    and match the Pallas kernels in interpret mode: K9's codes within one
    code (>= 99.9% equal) and its scales within 1e-6, the blocks within
    ``_close``."""
    n = _rng(11)
    w, hidden = 128, 384
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = _block_args(12, w, hidden)
    mlp, ln2 = args[8:14], args[14:]
    calls, ops = _recording_ops()
    if kernel == "K9":
        x = n(50, w, scale=2.0)
        k9 = (*args[8:11], *ln2)
        ref8, refs = jax_qm.quant_matmul_fused_qout(
            jnp.asarray(x, jdt), *(jnp.asarray(a) for a in k9),
            act="gelu_tanh", ln_eps=1e-6, interpret=True)
        y8, ys = qm._k9(ops, torch.from_numpy(x).to(tdt), *_t(*k9),
                        "gelu_tanh", 1e-6)
        d = np.abs(y8.numpy().astype(np.int32) - np.asarray(ref8, np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.999
        np.testing.assert_allclose(ys.numpy(), np.asarray(refs), rtol=1e-6,
                                   atol=0)
    elif kernel == "K11":
        x = n(50, w, scale=2.0)
        ref = jax_qm.quant_mlp_block_fused(
            jnp.asarray(x, jdt), *(jnp.asarray(a) for a in mlp + ln2),
            act="quick_gelu", interpret=True)
        out = qm._k11(ops, torch.from_numpy(x).to(tdt), *_t(*mlp, *ln2),
                      "quick_gelu", 1e-5)
        _close(out, ref, dtype)
    elif kernel.startswith("K14"):
        chunks = 2 if "2" in kernel else 1
        x = n(2, 17, w)
        ref = jax_qm.quant_full_block_fused(
            jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args), 2,
            mlp_chunks=chunks, act="quick_gelu", interpret=True)
        out = qm._k14(ops, torch.from_numpy(x).to(tdt), *_t(*args), 2, chunks,
                      "quick_gelu")
        _close(out, ref, dtype)
    else:
        y, res = n(60, w, scale=2.0), n(60, w)
        lns, lnb, gamma = 1 + n(w, scale=0.1), n(w, scale=0.1), n(w, scale=0.1)
        k15 = (lns, lnb, *mlp, gamma)
        ref = jax_qm.quant_convnext_mlp_block(
            jnp.asarray(y, jdt), jnp.asarray(res, jdt),
            *(jnp.asarray(a) for a in k15), interpret=True)
        out = qm._k15(ops, torch.from_numpy(y).to(tdt),
                      torch.from_numpy(res).to(tdt), *_t(*k15), "gelu_poly",
                      1e-6)
        _close(out, ref, dtype)
    # no row_quant reads a GEMM's output but K14's LN2 of its fp32 y1 (the
    # out-proj's output, which is no GEMM's hidden row): K9, K11 and K15 one
    # row_quant (the LN at the GEMM's input), K14 three (LN1, the attention
    # row, LN2); one GEMM each with the quantized output
    reads = [c[1] for c in calls if c[0] == "row_quant"]
    assert reads == ([False, False, True] if kernel.startswith("K14")
                     else [False])
    n_rq = {"K9": 1, "K11": 1, "K15": 1}.get(kernel, 3)
    assert sum(c[0] == "row_quant" for c in calls) == n_rq
    assert sum(c == ("int8_gemm", torch.int8) for c in calls) == 1


@pytest.mark.parametrize("k,n,group,pad", [
    (120, 256, 0, 0),      # K not a multiple of 16
    (128, 344, 172, 172),  # groups of 172 columns: not a multiple of 8
    (128, 256, 64, 64),    # two groups narrower than a 128-column tile
    (128, 336, 168, 180),  # a pad that is no multiple of 8
])
def test_quantized_output_refusals(k, n, group, pad):
    """What the kernel's quantized output does not take raises before any
    launch (the checks precede the device's)."""
    args = _gemm_operands(k + n, 64, k, n)
    with pytest.raises(ValueError, match="quantized int8_gemm"):
        qm._int8_gemm_qout(*args, "gelu_tanh", group, pad)


def test_quantized_output_refuses_more_tiles_than_sms(monkeypatch):
    """A block of the quantized output waits for its panel's other tiles,
    so a row of more 128-column tiles than the card has SMs (here 2) is
    refused by the kernel's form (``int8_gemm`` then takes two launches:
    ``tests/test_torch_cuda.py``)."""
    monkeypatch.setattr(qm, "_sm_count", lambda dev: 2)
    with pytest.raises(ValueError, match=r"2 SMs .*got N 264"):
        qm._int8_gemm_qout(*_gemm_operands(1, 8, 64, 264), "none", 0, 0)


@pytest.mark.parametrize("k,elem,ln,fits", [
    (29056, 4, True, True), (29060, 4, True, False),
    (58112, 4, False, True), (58116, 4, False, False),
    (38736, 2, True, True), (588, 2, False, True),
])
def test_row_quant_width_limit(k, elem, ln, fits):
    """``row_quant``'s kernel holds a row (with LN, also its fp32 LN
    values) in a block's shared memory; the wrapper refuses a wider one."""
    assert (qm.row_quant_bytes(k, elem, ln) <= qm.SMEM_MAX) == fits
