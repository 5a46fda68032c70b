"""The port's exact train augment (``ops/preprocess.py``: ``affine_warp``,
``train_transform``; ``aug_impl: exact``) against the JAX package's
(``aihab_clip_tpu/ops/preprocess.py:160-413``) on numpy-seeded uint8 images
and the same affine maps.  The two packages draw their maps from different
random streams (a ``torch.Generator`` against a JAX key), so the draws are
held equal only where a mode draws nothing (center and bottom crops); maps
built from the same numbers test the warp, the flip, the rotation and the
crop-frame mask.  Normalized outputs agree within 1e-4; raw warps within
1e-4 of the 0..255 range (measured 2.1e-3 of 255: the output-to-input
coordinates are summed in another order, which moves the bicubic weights in
their last bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aihab_clip_tpu.ops import preprocess as jp

from aihab_clip_tpu_torch.ops import preprocess as pp
from aihab_clip_tpu_torch.ops.fast_warp import fast_train_transform

RES = 32
NORM_ATOL, WARP_ATOL = 1e-4, 1e-4 * 255.0


def _images(seed, shape=(3, 47, 61, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _boxes(seed, b, h, w):
    """Crop boxes (top, left, crop_h, crop_w) and angles in degrees."""
    rng = np.random.default_rng(seed)
    ch = rng.integers(h // 2, h + 1, b).astype(np.float32)
    cw = rng.integers(w // 2, w + 1, b).astype(np.float32)
    top = np.floor(rng.random(b) * (h - ch + 1)).astype(np.float32)
    left = np.floor(rng.random(b) * (w - cw + 1)).astype(np.float32)
    theta = rng.uniform(-30.0, 30.0, b).astype(np.float32)
    return top, left, ch, cw, theta


def _maps(pkg, xp, top, left, ch, cw, theta, flips, rotation):
    """The maps of ``train_transform`` (``preprocess.py:364-388``) from
    given numbers, built by package ``pkg``'s own helpers."""
    mats = pkg._crop_matrix(*(xp(a) for a in (top, left, ch, cw)), RES)
    if flips is not None:
        flip = np.array([[-1.0, 0.0, float(RES)], [0.0, 1.0, 0.0]],
                        np.float32)
        ident = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
        mats = pkg._compose(mats, xp(np.where(flips[:, None, None], flip,
                                              ident)))
    rots = None
    if rotation:
        rots = pkg._rotation_matrix(xp(np.deg2rad(theta)), RES)
        mats = pkg._compose(mats, rots)
    return mats, rots


def _jax_from_maps(imgs, mats, rots, method):
    """JAX's ``train_transform`` tail (``preprocess.py:389-413``) on given
    maps: its warp, its crop-frame mask, the clip and its normalize."""
    warped = jp.affine_warp(jnp.asarray(imgs), mats, RES, method=method)
    if rots is not None:
        ys, xs = jnp.meshgrid(jnp.arange(RES, dtype=jnp.float32),
                              jnp.arange(RES, dtype=jnp.float32),
                              indexing="ij")
        coords = jnp.stack([xs.ravel() + 0.5, ys.ravel() + 0.5,
                            jnp.ones_like(xs).ravel()], 0)

        def frame_mask(rot):
            src = rot @ coords
            return ((src[0] >= 0.0) & (src[0] <= RES)
                    & (src[1] >= 0.0) & (src[1] <= RES))

        mask = jax.vmap(frame_mask)(rots).reshape(-1, RES, RES, 1)
        warped = jnp.where(mask, warped, 0.0)
    return np.asarray(jp.normalize(jnp.clip(warped, 0.0, 255.0)))


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("rotation", [False, True])
def test_affine_warp_matches_jax(method, rotation):
    imgs = _images(1)
    top, left, ch, cw, theta = _boxes(2, 3, 47, 61)
    jm, _ = _maps(jp, jnp.asarray, top, left, ch, cw, theta, None, rotation)
    tm, _ = _maps(pp, torch.from_numpy, top, left, ch, cw, theta, None,
                  rotation)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, rtol=0)
    ref = np.asarray(jp.affine_warp(jnp.asarray(imgs), jm, RES,
                                    method=method))
    got = pp.affine_warp(torch.from_numpy(imgs), tm, RES, method=method)
    assert got.dtype == torch.float32 and got.shape == (3, RES, RES, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=WARP_ATOL, rtol=0)
    if rotation:   # the corners leave the source: filled with 0
        assert (ref == 0).any() and ((got.numpy() == 0) == (ref == 0)).mean() > 0.99


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_rotated_flipped_crop_with_frame_mask_matches_jax(method):
    """Crop, flip and rotation composed, then the crop-frame mask: an
    interior crop rotated still goes black where the rotated grid leaves
    the crop frame, not only where it leaves the photo."""
    imgs = _images(3, (4, 64, 80, 3))
    top, left, ch, cw, theta = _boxes(4, 4, 64, 80)
    flips = np.array([True, False, True, False])
    jm, jr = _maps(jp, jnp.asarray, top, left, ch, cw, theta, flips, True)
    tm, tr = _maps(pp, torch.from_numpy, top, left, ch, cw, theta, flips,
                   True)
    ref = _jax_from_maps(imgs, jm, jr, method)
    got = pp.warp_normalize(torch.from_numpy(imgs), tm, tr, RES,
                            method=method)
    np.testing.assert_allclose(got.numpy(), ref, atol=NORM_ATOL, rtol=0)
    black = np.asarray(jp.normalize(jnp.zeros(3)))
    masked = np.all(np.isclose(ref, black), -1)
    assert masked.any() and not masked.all()


@pytest.mark.parametrize("crop_mode", ["center", "bottom"])
@pytest.mark.parametrize("shape", [(3, 47, 61, 3), (2, 64, 40, 3)])
def test_train_transform_matches_jax_where_nothing_is_drawn(crop_mode, shape):
    imgs = _images(5, shape)
    ref = np.asarray(jp.train_transform(jnp.asarray(imgs), jax.random.key(0),
                                        RES, crop_mode=crop_mode))
    got = pp.train_transform(torch.from_numpy(imgs),
                             torch.Generator().manual_seed(0), RES,
                             crop_mode=crop_mode)
    np.testing.assert_allclose(got.numpy(), ref, atol=NORM_ATOL, rtol=0)


def test_train_transform_draws_and_dtype():
    """``train_transform`` is ``warp_normalize`` over ``train_matrices``
    drawn from the generator: random crops of RandomResizedCrop's scale,
    flips, angles within +-30 degrees; bf16 out; the signature of
    ``fast_train_transform``."""
    imgs = torch.from_numpy(_images(6, (8, 48, 48, 3)))
    kw = dict(crop_mode="random", flip=True, rotation=True)
    got = pp.train_transform(imgs, torch.Generator().manual_seed(7), RES,
                             dtype=torch.bfloat16, **kw)
    mats, rots = pp.train_matrices(torch.Generator().manual_seed(7), 8, 48,
                                   48, RES, **kw)
    want = pp.warp_normalize(imgs, mats, rots, RES, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    angles = torch.rad2deg(torch.atan2(rots[:, 1, 0], rots[:, 0, 0]))
    assert angles.abs().max() <= 30.0 and angles.std() > 1.0
    other = pp.train_transform(imgs, torch.Generator().manual_seed(8), RES,
                               **kw)
    assert not torch.equal(other.to(torch.bfloat16), got)
    fast = fast_train_transform(imgs, torch.Generator().manual_seed(7), RES,
                                dtype=torch.bfloat16, **kw)
    assert fast.shape == got.shape and fast.dtype == got.dtype
