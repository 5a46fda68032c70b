"""The port's eval transform equals the JAX one (fp32 on the CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aihab_clip_tpu.ops import preprocess as jax_pre

from aihab_clip_tpu_torch.ops import preprocess


@pytest.mark.parametrize("h,w", [(240, 320), (320, 240), (256, 256),
                                 (239, 317)],
                         ids=["h<w", "h>w", "square", "odd"])
def test_eval_transform_matches_jax(h, w):
    imgs = np.random.default_rng(h * 1000 + w).integers(
        0, 256, (2, h, w, 3), dtype=np.uint8)
    ref = np.asarray(jax_pre.eval_transform(jnp.asarray(imgs), 224))
    out = preprocess.eval_transform(torch.from_numpy(imgs), 224)
    assert out.shape == (2, 224, 224, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=0)


def test_weight_mats_and_stats_match_jax():
    for h, w, r in [(439, 439, 224), (300, 500, 224), (17, 33, 8)]:
        for a, b in zip(preprocess._eval_weight_mats(h, w, r),
                        jax_pre._eval_weight_mats(h, w, r)):
            np.testing.assert_array_equal(a, b)
    assert preprocess.normalize_stats_for(None) == (jax_pre.CLIP_MEAN,
                                                    jax_pre.CLIP_STD)


def test_eval_transform_bf16_output():
    imgs = torch.randint(0, 256, (1, 224, 224, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    out = preprocess.eval_transform(imgs, 224, dtype=torch.bfloat16)
    ref = preprocess.eval_transform(imgs, 224)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=1e-2)
