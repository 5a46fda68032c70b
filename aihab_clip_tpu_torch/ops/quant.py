"""int8 quantization primitives for the serving/encode path (counterpart of
``aihab_clip_tpu/ops/quant.py``), in plain PyTorch on any device.

Scheme (standard W8A8 dynamic):
  * weights: symmetric per-output-channel int8
    (``scale_w[n] = max|W[:, n]| / 127``), quantized once at load time;
  * activations: symmetric per-row dynamic int8
    (``scale_x[m] = max|x[m, :]| / 127``);
  * the GEMM accumulates int32; dequant is the rank-1 outer scale
    ``y = acc * (scale_x * scale_w)``.

These divide by 127.0, as the JAX module does; the kernels of
``ops/quant_matmul.py`` multiply by (1/127), as the TPU kernels do.  Each
is kept as written, so the int8 codes and scales are bit-identical to the
JAX package's on the same fp32 inputs.  Integer products are taken in
float64, which is exact for int8 codes at any width this model has (a sum
of K products of at most 127^2 stays far below 2^53).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: w [K, N] -> (w8 [K, N] int8,
    scale [N] fp32) with w ~= w8 * scale."""
    wf = w.float()
    scale = wf.abs().amax(0).clamp_min(1e-12) / 127.0
    w8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return w8, scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: x [M, K] -> (x8 int8, scale [M, 1] fp32)."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
    x8 = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return x8, scale


def int_matmul(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes, as fp32 (``acc.astype(f32)``):
    a float64 product (exact) rounded once to fp32."""
    return (a8.double() @ b8.double()).float()


def quant_dense(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                out_dtype=None) -> torch.Tensor:
    """y = act(dequant(int8(x) @ w8) + bias), x [M, K] float, w8 [K, N]
    int8, w_scale [N] fp32."""
    out_dtype = out_dtype or x.dtype
    x8, sx = quantize_activation(x)
    y = int_matmul(x8, w8) * (sx * w_scale[None, :].float())
    if bias is not None:
        y = y + bias.float()[None, :]
    if act == "quick_gelu":
        y = y * torch.sigmoid(1.702 * y)
    elif act == "gelu_tanh":
        y = torch.nn.functional.gelu(y, approximate="tanh")
    elif act == "gelu":
        y = torch.nn.functional.gelu(y)
    elif act is not None:
        raise ValueError(f"unknown activation '{act}'")
    return y.to(out_dtype)
