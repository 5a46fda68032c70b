"""How a random ModifiedResNet tower's BatchNorms decide whether its bf16
encodes can be held against its fp32 one, on one card.

    python -m aihab_clip_tpu_torch.tools.rn_gains

A random tower (``random:RN50``, ``random:RN50x64``, seed 0) in three
BatchNorm settings: ``identity`` (the random init: mean 0, var 1, scale 1,
bias 0), ``unit`` (``calibrate_bn_`` with every scale U(0.5, 1.5)) and
``branch`` (the same, each block's last BatchNorm, its residual branch's
gain, U(0, 0.2): what ``chip_smoke.py`` uses).  For each, on a batch of
seeded photos at the tower's resolution (RN50: 32, RN50x64: 8), it prints
one JSON line: the fp32 features' mean pairwise cosine (``spread``: near 1,
the features say nothing of the image), their least cosine under 1e-3
N(0, 1) input noise (``fp32_noise``: below 1, the tower is chaotic and
amplifies any rounding), and the least cosine against the fp32 tower of the
bf16 canonical module (``canonical_bf16``) and of the folded encode
(``folded_bf16``).
"""

from __future__ import annotations

import copy
import json

import numpy as np

ARCHS = (("RN50", 32), ("RN50x64", 8))
BRANCH_GAIN = 0.2


def seeded_photos(n: int, dim: int, seed: int) -> np.ndarray:
    """[n, dim, dim, 3] uint8: per image, 16 px patches of colour drawn
    from numpy seed ``seed + i``, plus N(0, 8) noise."""
    out = np.empty((n, dim, dim, 3), np.uint8)
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        coarse = rng.normal(128, 60, (-(-dim // 16), -(-dim // 16), 3))
        out[i] = np.clip(np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:dim, :dim]
                         + rng.normal(0, 8, (dim, dim, 3)), 0, 255)
    return out


def calibrate_bn_(model, images_u8, seed: int,
                  branch_gain: float = BRANCH_GAIN) -> None:
    """Data-dependent BatchNorm statistics for a random RN tower: each
    FrozenBatchNorm's ``mean``/``var`` become those of its input over one
    fp32 forward of ``images_u8`` (uint8 [N, D, D, 3] on the model's
    device, D its resolution), as a trained tower's running statistics are
    its inputs'; from a generator seeded ``seed``, bias N(0, 0.2) and scale
    U(0.5, 1.5), except each block's last BatchNorm (``bn3``), U(0,
    ``branch_gain``) (``branch_gain=None``: U(0.5, 1.5) too)."""
    import torch

    from ..models.resnet import FrozenBatchNorm
    from ..ops.preprocess import eval_transform, normalize_stats_for

    g = torch.Generator().manual_seed(seed)
    bns = [(name, m) for name, m in model.visual.named_modules()
           if isinstance(m, FrozenBatchNorm)]

    def take_stats(m, args):
        x = args[0].float()
        m.mean.copy_(x.mean(dim=(0, 2, 3)))
        m.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    mean, std = normalize_stats_for(model.config)
    tower = copy.copy(model.visual)
    tower.dtype = torch.float32
    hooks = [m.register_forward_pre_hook(take_stats) for _, m in bns]
    try:
        with torch.no_grad():
            for name, m in bns:
                c = m.weight.numel()
                lo, hi = ((0.0, branch_gain) if branch_gain is not None
                          and name.endswith(".bn3") else (0.5, 1.5))
                m.weight.copy_(lo + (hi - lo) * torch.rand(c, generator=g))
                m.bias.copy_(torch.randn(c, generator=g) * 0.2)
            tower(eval_transform(images_u8, model.config.image_resolution,
                                 mean=mean, std=std))
    finally:
        for h in hooks:
            h.remove()


def main() -> None:
    import torch
    import torch.nn.functional as F

    from ..models import fast_vit, zoo
    from ..ops.preprocess import eval_transform, normalize_stats_for

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, n in ARCHS:
        bundle = zoo.load(f"random:{arch}", dtype=torch.bfloat16,
                          device="cuda", seed=0)
        model, cfg = bundle.model, bundle.config
        res = cfg.image_resolution
        mean, std = normalize_stats_for(cfg)
        x32 = eval_transform(torch.from_numpy(seeded_photos(n, res, 500))
                             .cuda(), res, mean=mean, std=std)
        noise = torch.randn(x32.shape, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
        calib = torch.from_numpy(seeded_photos(16, res, 11)).cuda()
        start = {k: v.clone() for k, v in model.state_dict().items()}
        for setting in ("identity", "unit", "branch"):
            model.load_state_dict(start)
            if setting != "identity":
                calibrate_bn_(model, calib, 11, BRANCH_GAIN
                              if setting == "branch" else None)
            ref_tower = copy.copy(model.visual)
            ref_tower.dtype = torch.float32
            packed = fast_vit.pack_fastest(model, cfg, torch.bfloat16)
            with torch.inference_mode():
                ref = ref_tower(x32, project=True)[1]
                got = {
                    "fp32_noise": ref_tower(x32 + 1e-3 * noise,
                                            project=True)[1],
                    "canonical_bf16": model.encode_image(
                        x32.bfloat16(), project=True)[1].float(),
                    "folded_bf16": fast_vit.encode_image_fastest(
                        model, x32.bfloat16(), cfg, project=True,
                        packed=packed)[1].float()}
            f = F.normalize(ref, dim=-1)
            row = {"arch": arch, "setting": setting, "images": n,
                   "spread": (((f @ f.T).sum() - n) / (n * n - n)).item(),
                   "card": torch.cuda.get_device_name(0)}
            row.update({k: F.cosine_similarity(v, ref, dim=-1).min().item()
                        for k, v in got.items()})
            print(json.dumps(row), flush=True)
        del bundle, model, start, packed
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
