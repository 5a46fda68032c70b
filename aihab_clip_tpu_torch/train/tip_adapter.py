"""Tip-Adapter-style cache model and the few-shot helpers (counterpart of
``aihab_clip_tpu/train/tip_adapter.py``): the reference's legacy method
utilities.

  * ``build_cache_model``: keys = the mean over augmentation views of the
    L2-normalised train features, normalised again, [D, N]; values = the
    one-hot labels [N, C].  ``cache_from_feature_cache`` reads the keys'
    views from the port's pre-projection feature cache
    (``cache/feature_cache.read_preprojection_cache``);
  * ``tip_logits``: 100 x features @ clip_weights + alpha x exp(-beta (1 -
    affinity)) @ values;
  * ``search_hp_tip``: the (beta, alpha) grid maximising top-1 accuracy, the
    affinity and the zero-shot logits computed once;
  * ``compute_centroids`` / ``compute_mean_centroids``,
    ``compute_confidence_interval`` and ``pre_load_features`` (a
    post-projection feature cache of npy files for probes).

Tensors stay on the device they are given (fp32 matmuls; TF32 off on a
card, ``_full_fp32``); the cache model is built on the host in numpy, as in
JAX, and placed on the card unless the caller passes ``device="cpu"``.  No kernel: JAX left all of it to XLA.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..backend import resolve_device


def _full_fp32() -> None:
    """fp32 matmuls in full fp32 on a card (TF32 keeps ~3 digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype=torch.float32) -> torch.Tensor:
    return torch.nn.functional.one_hot(torch.as_tensor(labels).long(),
                                       num_classes).to(dtype)


def compute_centroids(features: torch.Tensor, labels: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """Per-class feature sums [C, D] (a one-hot matmul)."""
    _full_fp32()
    oh = one_hot(labels, num_classes, features.dtype).to(features.device)
    return oh.T @ features


def compute_mean_centroids(features: torch.Tensor, labels: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """Per-class feature means [C, D] (an empty class gives zeros)."""
    _full_fp32()
    oh = one_hot(labels, num_classes, features.dtype).to(features.device)
    counts = torch.clamp(oh.sum(0)[:, None], min=1.0)
    return (oh.T @ features) / counts


def build_cache_model(
    encode_views: Callable[[int], Tuple[np.ndarray, np.ndarray]],
    augment_epochs: int,
    num_classes: int,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Tip-Adapter cache: keys [D, N] = the mean over the
    ``augment_epochs`` views (``encode_views(v) -> (features [N, D],
    labels [N])``) of the normalised features, normalised again; values
    [N, C] = the one-hot labels of view 0.  Built in numpy fp32, returned as
    fp32 tensors on ``device`` (default the card, ``resolve_device``)."""
    device = resolve_device(device)
    feats_sum = labels0 = None
    for v in range(augment_epochs):
        feats, labels = encode_views(v)
        feats = np.array(feats, np.float32)
        feats /= np.maximum(np.linalg.norm(feats, axis=-1, keepdims=True),
                            1e-12)
        feats_sum = feats if feats_sum is None else feats_sum + feats
        if v == 0:
            labels0 = np.asarray(labels)
    keys = feats_sum / augment_epochs
    keys /= np.maximum(np.linalg.norm(keys, axis=-1, keepdims=True), 1e-12)
    values = np.eye(num_classes, dtype=np.float32)[labels0]
    return (torch.from_numpy(np.ascontiguousarray(keys.T)).to(device),
            torch.from_numpy(values).to(device))


def cache_from_feature_cache(cache_dir, aug_views: int, num_classes: int,
                             device=None):
    """``build_cache_model`` over the views of the port's pre-projection
    feature cache (``f{v}.npy`` + ``label.npy``, fp16 features)."""
    from ..cache.feature_cache import read_preprojection_cache

    views, labels = read_preprojection_cache(cache_dir, aug_views)
    return build_cache_model(lambda v: (views[v], labels), aug_views,
                             num_classes, device=device)


def tip_logits(features: torch.Tensor, cache_keys: torch.Tensor,
               cache_values: torch.Tensor, clip_weights: torch.Tensor,
               beta: float, alpha: float) -> torch.Tensor:
    """Tip-Adapter logits: the CLIP zero-shot logits plus alpha times the
    cache-affinity term."""
    _full_fp32()
    affinity = features @ cache_keys                          # [B, N]
    cache_logits = torch.exp(-beta + beta * affinity) @ cache_values
    return 100.0 * features @ clip_weights + alpha * cache_logits


def search_hp_tip(
    features: torch.Tensor,
    labels,
    cache_keys: torch.Tensor,
    cache_values: torch.Tensor,
    clip_weights: torch.Tensor,
    search_scale: Tuple[float, float] = (7.0, 3.0),
    search_step: Tuple[int, int] = (200, 20),
    verbose: bool = False,
) -> Tuple[float, float, float]:
    """(beta, alpha) grid search maximising top-1 accuracy; returns (beta,
    alpha, accuracy in %).  The affinity and the zero-shot logits are
    computed once; per beta one exp and one matmul, per alpha one add.  The
    grid and the first-best tie rule are JAX's (``tip_adapter.py:74-112``)."""
    _full_fp32()
    beta_list = [i * (search_scale[0] - 0.1) / search_step[0] + 0.1
                 for i in range(search_step[0])]
    alpha_list = [i * (search_scale[1] - 0.1) / search_step[1] + 0.1
                  for i in range(search_step[1])]
    affinity = features @ cache_keys
    clip_logits = 100.0 * features @ clip_weights
    labels = torch.as_tensor(np.asarray(labels)).to(features.device)

    best = (0.0, 0.0, 0.0)
    for beta in beta_list:
        cache_logits = torch.exp(-beta + beta * affinity) @ cache_values
        accs = torch.stack([
            ((clip_logits + alpha * cache_logits).argmax(-1) == labels)
            .float().mean() for alpha in alpha_list]).cpu().numpy()
        for alpha, acc in zip(alpha_list, accs):
            acc = float(acc * np.float32(100.0))
            if acc > best[0]:
                if verbose:
                    print(f"New best setting, beta: {beta:.2f}, "
                          f"alpha: {alpha:.2f}; accuracy: {acc:.2f}")
                best = (acc, beta, alpha)
    if verbose:
        print(f"\nAfter searching, the best accuracy: {best[0]:.2f}.\n")
    return best[1], best[2], best[0]


def compute_confidence_interval(data, axis: int = 0) -> Tuple[float, float]:
    """Mean and 95% half-width (1.96 std / sqrt(n)) of sampled accuracies."""
    a = 1.0 * np.asarray(data)
    m = np.mean(a, axis=axis)
    pm = 1.96 * (np.std(a, axis=axis) / np.sqrt(a.shape[axis]))
    return m, pm


def pre_load_features(cache_dir: Path, split: str,
                      encode_split: Optional[Callable] = None,
                      load_cached: bool = True):
    """A post-projection feature cache for probes: ``<split>_f.npy`` and
    ``<split>_l.npy`` under ``cache_dir``, encoded once by
    ``encode_split() -> (features, labels)`` and read back thereafter."""
    cache_dir = Path(cache_dir)
    fpath = cache_dir / f"{split}_f.npy"
    lpath = cache_dir / f"{split}_l.npy"
    if load_cached and fpath.is_file() and lpath.is_file():
        return np.load(fpath), np.load(lpath)
    if encode_split is None:
        raise FileNotFoundError(f"No cached features at {fpath}")
    feats, labels = encode_split()
    feats, labels = (t.detach().cpu().numpy() if torch.is_tensor(t)
                     else np.asarray(t) for t in (feats, labels))
    cache_dir.mkdir(parents=True, exist_ok=True)
    np.save(fpath, feats)
    np.save(lpath, labels)
    return feats, labels
