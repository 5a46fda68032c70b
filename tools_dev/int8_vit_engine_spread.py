"""The port's int8 CLIP ViT engine against the JAX CPU engine over several
model and image seeds, on the CPU.

Builds ``tests/test_torch_quant_vit.py``'s engine tower (2 blocks, patch 8
at 32 px, two heads of 64) for each model seed, writes it to a temporary
converted cache with the JAX package, and loads both engines from it with
``quantize="int8"``.  For each image seed it classifies 6 random uint8
224x224 images with both and prints the number of top-1 classes that
differ and max|dprob|.  The JAX CPU engine runs its ``impl="xla"`` int8
reference on its own preprocessing; these readings set the end-to-end
smoke limits of ``test_int8_vit_engine_matches_jax``.

Usage: env JAX_PLATFORMS=cpu python tools_dev/int8_vit_engine_spread.py \\
           [--width 128] [--models 16-23] [--images 18-20]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np


def _seeds(text: str):
    lo, _, hi = text.partition("-")
    return range(int(lo), int(hi or lo) + 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--models", default="16-23")
    ap.add_argument("--images", default="18-20")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    import aihab_clip_tpu.models.zoo as jax_zoo
    import aihab_clip_tpu_torch.models.zoo as zoo
    from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
    from aihab_clip_tpu.models.convert import save_params_npz
    from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
    from aihab_clip_tpu_torch.serving import ClassifierEngine

    torch.set_num_threads(1)
    tower = dict(embed_dim=64, image_resolution=32, vision_layers=2,
                 vision_width=args.width, vision_patch_size=8,
                 context_length=77, vocab_size=49408, transformer_width=64,
                 transformer_heads=1, transformer_layers=1)
    name = "torch-quant-vit"
    rows = []
    for seed in _seeds(args.models):
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            bundle = jax_zoo.load("random:" + name,
                                  random_cfg=JaxCLIPConfig(**tower), seed=seed)
            npz = jax_zoo._npz_cache_path(name, root)
            npz.parent.mkdir(parents=True)
            save_params_npz(npz, bundle.params)
            jax_zoo._save_config(jax_zoo._config_cache_path(name, root),
                                 bundle.config)
            roots = (jax_zoo.default_cache_root, zoo.default_cache_root)
            jax_zoo.default_cache_root = zoo.default_cache_root = \
                lambda: root
            try:
                ref = JaxEngine(model=name, batch_size=4, flat=True,
                                quantize="int8", verbose=False)
                port = ClassifierEngine(model=name, batch_size=4, flat=True,
                                        quantize="int8", verbose=False,
                                        device="cpu")
            finally:
                jax_zoo.default_cache_root, zoo.default_cache_root = roots
        for iseed in _seeds(args.images):
            imgs = np.random.default_rng(iseed).integers(
                0, 256, (6, 224, 224, 3), dtype=np.uint8)
            want = np.concatenate([ref.classify_batch(imgs[:4]),
                                   ref.classify_batch(imgs[4:])])
            got = np.concatenate([port.classify_batch(imgs[:4]),
                                  port.classify_batch(imgs[4:])])
            flips = int((got.argmax(-1) != want.argmax(-1)).sum())
            dprob = float(np.abs(got - want).max())
            rows.append((flips, dprob))
            print(f"model seed {seed} image seed {iseed}: top-1 differs on "
                  f"{flips} of 6, max|dprob| {dprob:.4g}", flush=True)
    dprobs = [d for _, d in rows]
    print(f"{len(rows)} draws at width {args.width}: max|dprob| "
          f"{min(dprobs):.4g} to {max(dprobs):.4g}; top-1 differs in "
          f"{sum(f > 0 for f, _ in rows)}, at most {max(f for f, _ in rows)} "
          f"of 6; top-1 equal and <= 2e-2 in "
          f"{sum(f == 0 and d <= 2e-2 for f, d in rows)}")


if __name__ == "__main__":
    main()
