"""Writes ``tests/golden/jax_written/``: small files that the JAX package (and
the libraries it writes through) produced, with the arrays they hold, so the
port's readers are checked against them on any machine, the card's included
(which has no JAX, orbax, tensorstore or zstandard).

  orbax_ckpt/          JAX's ``save_checkpoint`` of a tiny ViT tower
                       (params; one block) and its ``inject_hyperparams(adam)``
                       state after three steps over the block, ``ln_post``
                       and ``proj`` (the trainable part of a PEFT run);
                       ``orbax_ckpt.npz`` holds every array by its orbax
                       name (``params.visual.proj``,
                       ``opt_state.inner_state.0.mu.visual.proj``, ...)
  tensorstore_store/   ``TensorStoreStore.save`` of arrays of several dtypes
                       (blosc/LZ4, one of two chunks, an empty one, a 0-d
                       one); ``tensorstore_store.npz`` holds them (the
                       bfloat16 one as its uint16 bits)
  zstd/                libzstd frames of structured data at levels -5, 1, 3,
                       19 and 22, with and without checksum and content
                       size; ``zstd.json`` maps each file to the SHA-256 of
                       its decoded bytes

Run from the repository root (it needs the JAX package, orbax, tensorstore
and zstandard; it rewrites the directory):

    JAX_PLATFORMS=cpu python tests/make_jax_written_fixtures.py
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "golden" / "jax_written"
sys.path.insert(0, str(ROOT))

TOWER = dict(embed_dim=16, image_resolution=16, vision_layers=1,
             vision_width=64, vision_patch_size=8, context_length=77,
             vocab_size=49408, transformer_width=32, transformer_heads=1,
             transformer_layers=1)


def _flat(tree, prefix=""):
    """orbax's names: tree keys (and sequence indices) joined by '.'."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (tuple, list))
             else None)
    if items is None:
        return {prefix[:-1]: np.asarray(tree)}
    for k, v in items:
        if v is None or (isinstance(v, (dict, tuple, list)) and not v):
            continue
        out.update(_flat(v, f"{prefix}{k}."))
    return out


def orbax_checkpoint():
    import jax
    import optax
    from flax import traverse_util

    from aihab_clip_tpu.config import ConfigNode
    from aihab_clip_tpu.models import CLIPConfig
    from aihab_clip_tpu.models import load
    from aihab_clip_tpu.utils import save_checkpoint

    bundle = load("random:tiny-tower", random_cfg=CLIPConfig(**TOWER), seed=4)
    params = {"visual": jax.tree.map(np.asarray, bundle.params["visual"])}
    flat = traverse_util.flatten_dict(params)
    last = f"resblocks_{TOWER['vision_layers'] - 1}"
    train = {k: v for k, v in flat.items()
             if last in k or k[1] in ("ln_post", "proj")}
    trainable = traverse_util.unflatten_dict(train)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=2e-3)
    state = opt.init(trainable)
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            trainable)
        state.hyperparams["learning_rate"] = np.float32(2e-3 * (0.9 ** step))
        updates, state = opt.update(grads, state, trainable)
        trainable = optax.apply_updates(trainable, updates)
    merged = dict(flat)
    merged.update(traverse_util.flatten_dict(trainable))
    params = traverse_util.unflatten_dict(merged)
    # a relative root: meta.json records the config as given
    cwd = os.getcwd()
    os.chdir(OUT)
    try:
        cfg = ConfigNode({"root_path": "_tmp", "clip_backend": "openclip",
                          "open_clip_model": "tiny-tower",
                          "finetune": {"save_model_dir": "ck"}})
        path = save_checkpoint(cfg, params, state, epoch=3)
        shutil.move(str(path), OUT / "orbax_ckpt")
        shutil.rmtree(OUT / "_tmp")
    finally:
        os.chdir(cwd)
    arrays = _flat({"params": params, "opt_state": {
        "count": state.count, "hyperparams": state.hyperparams,
        "inner_state": (dict(state.inner_state[0]._asdict()),)}})
    np.savez_compressed(OUT / "orbax_ckpt.npz", **arrays)


def tensorstore_store():
    import jax.numpy as jnp

    from aihab_clip_tpu.cache.array_store import TensorStoreStore

    rng = np.random.default_rng(3)
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((16, 16)),
                                  jnp.bfloat16))
    arrays = {
        "f16": rng.standard_normal((64, 32)).astype(np.float16),
        "f32": rng.standard_normal((100, 40)).astype(np.float32),
        "i64": np.arange(300, dtype=np.int64) * 7 - 100,
        # two chunks ([1048, 1000]); bit-shuffled blocks and a short last one
        "u8": (np.arange(1100 * 1000) % 251 // 7).astype(np.uint8).reshape(
            1100, 1000),
        "bool": rng.random(333) > 0.4,
        "empty": np.zeros((0, 8), np.float32),
        "scalar": np.float32(2.5),
    }
    store = TensorStoreStore(f"file://{OUT / 'tensorstore_store'}")
    for name, a in arrays.items():
        store.save(name, a)
    store.save("bf16", bf16)
    store.write_json("manifest.json", {"arrays": sorted(arrays) + ["bf16"]})
    arrays["bf16"] = bf16.view(np.uint16)
    np.savez_compressed(OUT / "tensorstore_store.npz", **arrays)


def zstd_frames():
    import zstandard

    rng = np.random.default_rng(5)
    text = "".join(f'{{"plot": {i}, "label": "L3-{i % 37}", "score": '
                   f'{rng.standard_normal():.6f}}}\n'
                   for i in range(1000)).encode()
    weights = (rng.standard_normal(2000) * 0.02).astype(np.float32).tobytes()
    (OUT / "zstd").mkdir()
    digests = {}
    for level in (-5, 1, 3, 19, 22):
        for name, data in (("text", text), ("weights", weights)):
            for checksum, size in ((True, True), (False, False)):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=size).compress(data)
                fname = (f"{name}_l{level}_{'c' if checksum else 'n'}"
                         f"{'s' if size else 'n'}.zst")
                (OUT / "zstd" / fname).write_bytes(frame)
                digests[fname] = hashlib.sha256(data).hexdigest()
    (OUT / "zstd.json").write_text(json.dumps(digests, indent=1,
                                              sort_keys=True))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    orbax_checkpoint()
    tensorstore_store()
    zstd_frames()
    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"wrote {OUT} ({total} bytes)")


if __name__ == "__main__":
    main()
