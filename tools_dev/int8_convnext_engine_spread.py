"""The port's int8 ConvNeXt engine against the JAX CPU engine over several
model and image seeds, on the CPU.

Builds ``tests/test_torch_convnext.py``'s engine tower (``TinyConvNeXt``,
its layer scales redrawn at N(0, 0.3) from the model seed) for each model
seed, writes it to a temporary converted cache with the JAX package, and
loads both engines from it with ``quantize="int8"``.  For each image seed
it classifies 6 random uint8 224x224 images with both and prints the number
of top-1 classes that differ and max|dprob|.  Both engines compute in fp32
on the CPU, the port through the plain K15 and JAX through its
interpret-mode kernel, each on its own preprocessing; these readings set
the limits of ``test_int8_convnext_engine_matches_jax``.

Usage: env JAX_PLATFORMS=cpu python tools_dev/int8_convnext_engine_spread.py \\
           [--models 30-37] [--images 33-35]
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
    ap.add_argument("--models", default="30-37")
    ap.add_argument("--images", default="33-35")
    args = ap.parse_args()
    root_dir = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root_dir))
    sys.path.insert(0, str(root_dir / "tests"))

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch

    import aihab_clip_tpu.models.zoo as jax_zoo
    import aihab_clip_tpu_torch.models.zoo as zoo
    from aihab_clip_tpu.models import CLIPConfig as JaxCLIPConfig
    from aihab_clip_tpu.models.convert import save_params_npz
    from aihab_clip_tpu.serving import ClassifierEngine as JaxEngine
    from aihab_clip_tpu_torch.serving import ClassifierEngine
    from test_torch_convnext import TINY, _jax_params, _redraw_gamma

    torch.set_num_threads(1)
    jcfg = JaxCLIPConfig(**TINY)
    name = "torch-convnext_base_w-engine"
    rows = []
    for seed in _seeds(args.models):
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            npz = jax_zoo._npz_cache_path(name, root)
            npz.parent.mkdir(parents=True)
            save_params_npz(npz, _redraw_gamma(_jax_params(jcfg, seed)[1],
                                               seed))
            jax_zoo._save_config(jax_zoo._config_cache_path(name, root), jcfg)
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
            d = float(np.abs(got - want).max())
            rows.append((seed, iseed, flips, d))
            print(f"model seed {seed} images seed {iseed}: top-1 differs on "
                  f"{flips} of 6, max|dprob| {d:.3g}", flush=True)
    ds = [r[3] for r in rows]
    print(f"{len(rows)} draws: max|dprob| {min(ds):.3g} to {max(ds):.3g}; "
          f"top-1 flips in {sum(r[2] > 0 for r in rows)} draws")


if __name__ == "__main__":
    main()
