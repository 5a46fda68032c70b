"""The benchmark's FLOP and byte counts against counts made by hand."""

import json

import pytest

from benchmark import arith
from benchmark.harness import ROOT


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def test_so400m_image_flops_by_hand():
    cfg = config("siglip2-so400m-16-384")
    s, w, h = 576, 1152, 4304
    block = 2 * s * (3 * w * w + w * w + 2 * w * h) + 4 * s * s * w
    assert block == pytest.approx(19.07e9, rel=1e-3)
    embed = 2 * s * (3 * 16 * 16) * w
    head = (2 * w * w + 2 * 2 * s * w * w + 4 * s * w + 2 * w * w
            + 2 * 2 * w * h)
    assert arith.image_flops(cfg) == 27 * block + embed + head
    assert arith.image_flops(cfg) == pytest.approx(518.9e9, rel=1e-3)


def test_vitb16_image_flops_by_hand():
    cfg = config("clip-vit-b-16")
    s, w = 197, 768
    block = 2 * s * (4 * w * w + 2 * w * 3072) + 4 * s * s * w
    embed = 2 * 196 * 768 * w
    assert arith.image_flops(cfg) == 12 * block + embed + 2 * w * 512
    assert arith.image_flops(cfg) == pytest.approx(35.1e9, rel=2e-3)


def test_train_step_flops_by_hand():
    cfg = config("siglip2-so400m-16-384")
    fwd = arith.image_flops(cfg)
    suffix = arith.image_flops(cfg, start=17, embed=False)
    s, w, h = 64, 1152, 4304
    text = 20 * (27 * (2 * s * (4 * w * w + 2 * w * h) + 4 * s * s * w)
                 + 2 * w * w)
    want = 16 * fwd + 2 * 16 * suffix + text + 2 * 20 * 2 * w * w
    assert arith.train_step_flops(cfg, 16, 17, 20) == want
    block = 2 * 576 * (4 * w * w + 2 * w * h) + 4 * 576 * 576 * w
    assert suffix == 10 * block + arith.image_head_flops(cfg)


def test_bounds_by_hand():
    cfg = config("siglip2-so400m-16-384")
    peaks = arith.PEAKS["H100 80GB HBM3"]
    m = 64 * 576
    gemm = 2 * m * (4 * 1152 ** 2 + 2 * 1152 * 4304) / 989e12
    assert arith.gemm_bound_s(cfg, 64, peaks) == pytest.approx(27 * gemm)
    fl = 4 * 64 * 576 * 576 * 1152 / 989e12
    by = 4 * 2 * 64 * 576 * 1152 / 3.35e12
    assert by > fl        # SO400M's attention at batch 64 is bound by bytes
    assert arith.attention_bound_s(cfg, 64, peaks, 27) == pytest.approx(
        27 * by)
    bwd = max(2 * 4 * 16 * 576 ** 2 * 1152 / 989e12,
              (8 * 2 * 16 * 576 * 1152 + 4 * 16 * 16 * 576) / 3.35e12)
    fwd = max(4 * 16 * 576 ** 2 * 1152 / 989e12,
              8 * 16 * 576 * 1152 / 3.35e12)
    assert arith.attention_bound_s(cfg, 16, peaks, 27, 10) == pytest.approx(
        27 * fwd + 10 * bwd)


def test_peaks_by_device_name():
    assert arith.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert arith.peaks_for("NVIDIA A100-SXM4-80GB") is None
