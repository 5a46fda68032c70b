"""The port's matmul-formulated train augmentation against the JAX package
(``aihab_clip_tpu/ops/fast_warp.py``): the separable crop/flip/resize at
fixed boxes, the 3-shear rotation at a fixed angle, the deterministic crop
modes of ``fast_train_transform``, and the random crop boxes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.ops import fast_warp as jax_warp
from aihab_clip_tpu.ops import preprocess as jax_pre

from aihab_clip_tpu_torch.ops import fast_warp, preprocess

SIGLIP = ((0.5,) * 3, (0.5,) * 3)


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_separable_resize_crop_matches_jax(method):
    images = _u8(0, (3, 40, 50, 3))
    boxes = np.array([[2, 3, 30, 35], [0, 0, 40, 50], [5.5, 7.25, 20, 22]],
                     np.float32)
    flips = np.array([False, True, True])
    ref = jax_warp.separable_resize_crop(
        jnp.asarray(images), jnp.asarray(boxes), 24,
        flip_mask=jnp.asarray(flips), method=method)
    out = fast_warp.separable_resize_crop(
        torch.from_numpy(images), torch.from_numpy(boxes), 24,
        flip_mask=torch.from_numpy(flips), method=method)
    assert out.shape == (3, 24, 24, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("theta", [0.3, -0.45])
def test_rotate_shear_matches_jax(theta):
    images = _u8(1, (2, 24, 24, 3)).astype(np.float32)
    ref = jax_warp.rotate_shear(jnp.asarray(images), jnp.float32(theta))
    out = fast_warp.rotate_shear(torch.from_numpy(images), theta)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3)


@pytest.mark.parametrize("crop_mode", ["center", "bottom"])
@pytest.mark.parametrize("shape", [(4, 48, 40, 3), (2, 40, 56, 3)])
def test_deterministic_train_transform_matches_jax(crop_mode, shape):
    """center/bottom crops, no flip, no rotation: no randomness, so the
    two packages agree after normalisation."""
    images = _u8(2, shape)
    ref = jax_warp.fast_train_transform(
        jnp.asarray(images), jax.random.key(0), 32, crop_mode=crop_mode,
        mean=SIGLIP[0], std=SIGLIP[1])
    out = fast_warp.fast_train_transform(
        torch.from_numpy(images), torch.Generator().manual_seed(0), 32,
        crop_mode=crop_mode, mean=SIGLIP[0], std=SIGLIP[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


def test_random_crop_boxes_stay_inside_the_image():
    g = torch.Generator().manual_seed(3)
    for h, w in ((439, 439), (48, 40), (60, 90), (30, 90)):
        box = fast_warp.train_boxes(g, 256, h, w, 32, "random")
        top, left, ch, cw = box.unbind(-1)
        assert (top >= 0).all() and (left >= 0).all()
        assert (top + ch <= h).all() and (left + cw <= w).all()
        assert (ch >= 1).all() and (cw >= 1).all()
        if (h, w) == (30, 90):   # no draw fits: the fallback center crop
            assert (box == torch.tensor([0.0, 25.0, 30.0, 40.0])).all()
            continue
        area = (ch * cw) / (h * w)
        assert (area > 0.45).all() and (area <= 1.0).all()
        assert len(torch.unique(box, dim=0)) > 200     # the draws vary


def test_random_crop_fallback_matches_jax():
    """An image no draw fits (aspect 20:1) takes the fallback center crop,
    which does not depend on the draws."""
    ref = jax_pre._random_resized_crop_params(jax.random.key(0), 10, 200)
    box = preprocess._random_resized_crop_params(
        torch.Generator().manual_seed(0), 4, 10, 200)
    for row in box:
        np.testing.assert_array_equal(row.numpy(),
                                      np.asarray(jnp.stack(ref), np.float32))


def test_random_transform_is_seeded_and_normalised():
    images = torch.from_numpy(_u8(4, (3, 48, 48, 3)))

    def run(seed):
        return fast_warp.fast_train_transform(
            images, torch.Generator().manual_seed(seed), 32, flip=True,
            rotation=True, dtype=torch.bfloat16)

    a, b, c = run(5), run(5), run(6)
    assert a.shape == (3, 32, 32, 3) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a.float()).all()
    lo = (0.0 - np.array(preprocess.CLIP_MEAN)) / np.array(preprocess.CLIP_STD)
    hi = (1.0 - np.array(preprocess.CLIP_MEAN)) / np.array(preprocess.CLIP_STD)
    x = a.float().numpy()
    assert (x >= lo.min() - 0.02).all() and (x <= hi.max() + 0.02).all()


def test_normalize_and_cubic_kernel_match_jax():
    x = _u8(6, (2, 5, 5, 3))
    np.testing.assert_allclose(
        preprocess.normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pre.normalize(jnp.asarray(x))), atol=1e-6)
    t = np.linspace(-2.5, 2.5, 101).astype(np.float32)
    np.testing.assert_allclose(
        preprocess._cubic_kernel(torch.from_numpy(t)).numpy(),
        np.asarray(jax_pre._cubic_kernel(jnp.asarray(t))), atol=1e-6)


def test_unknown_crop_mode_raises():
    with pytest.raises(ValueError, match="crop_mode"):
        fast_warp.train_boxes(torch.Generator(), 2, 8, 8, 8, "ratio")
