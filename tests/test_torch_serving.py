"""The slice as a whole: a model written to the converted cache by the JAX
package classifies the same uint8 batch in both ``ClassifierEngine``s,
and the port's ``DynamicBatcher`` answers single-image requests."""

import numpy as np
import pytest

import aihab_clip_tpu.models.zoo as jax_zoo
from aihab_clip_tpu.models import CLIPConfig as JaxConfig
from aihab_clip_tpu.models.convert import save_params_npz
from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine

import aihab_clip_tpu_torch.models.zoo as zoo
from aihab_clip_tpu_torch.serving import (ClassifierEngine, DynamicBatcher,
                                          ServerStats)

NAME = "torch-serving-vit"
CFG = dict(embed_dim=32, image_resolution=32, vision_layers=2,
           vision_width=128, vision_patch_size=8, context_length=77,
           vocab_size=49408, transformer_width=64, transformer_heads=1,
           transformer_layers=2)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    bundle = jax_zoo.load("random:" + NAME, random_cfg=JaxConfig(**CFG),
                          seed=5)
    npz = jax_zoo._npz_cache_path(NAME, root)
    npz.parent.mkdir(parents=True)
    save_params_npz(npz, bundle.params)
    jax_zoo._save_config(jax_zoo._config_cache_path(NAME, root), bundle.config)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_zoo, "default_cache_root", lambda: root)
    mp.setattr(zoo, "default_cache_root", lambda: root)
    try:
        ref = JaxEngine(model=NAME, batch_size=4, flat=True, verbose=False)
        port = ClassifierEngine(model=NAME, batch_size=4, flat=True,
                                verbose=False, device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_engine_matches_jax(engines):
    ref, port = engines
    assert port.bundle.source == "npz-cache"
    assert (port.decode_dim, port.bucket_sizes) == (ref.decode_dim,
                                                    ref.bucket_sizes)
    imgs = np.random.default_rng(0).integers(0, 256, (3, 224, 224, 3),
                                             dtype=np.uint8)
    want = ref.classify_batch(imgs)
    got = port.classify_batch(imgs)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert port.topk(got, 2)[0][0]["name"] == ref.topk(want, 2)[0][0]["name"]


def test_text_head_matches_jax(engines):
    ref, port = engines
    np.testing.assert_allclose(port._text_weights.numpy(),
                               np.asarray(ref._text_weights), atol=1e-5)


def test_dynamic_batcher_answers(engines):
    _, port = engines
    port.warmup()
    assert port.warm
    imgs = np.random.default_rng(1).integers(0, 256, (6, 224, 224, 3),
                                             dtype=np.uint8)
    stats = ServerStats()
    batcher = DynamicBatcher(port, max_wait_ms=20.0, stats=stats)
    batcher.start()
    try:
        futures = [batcher.submit(img) for img in imgs]
        probs = np.stack([f.result(timeout=60) for f in futures])
    finally:
        batcher.stop()
    assert all(not t.is_alive() for t in batcher._threads)
    direct = np.concatenate([port.classify_batch(imgs[:4]),
                             port.classify_batch(imgs[4:])])
    np.testing.assert_allclose(probs, direct, atol=1e-6)
    snap = stats.snapshot(port.batch_size)
    assert stats.batch_fill == 6 and snap["batches"] >= 2
    assert 0 < snap["mean_batch_fill"] <= 1


def test_dispatch_rejects_bad_shapes(engines):
    _, port = engines
    with pytest.raises(ValueError, match="expected"):
        port.classify_dispatch(np.zeros((3, 224, 224, 3), np.uint8))
    assert port.bucket_for(3) == 4 and port.bucket_for(99) == 4
