"""ProLIP: projector-only tuning on cached pre-projection features
(counterpart of ``aihab_clip_tpu/train/prolip.py``).

  * the projector is the model's own visual projection, trainable (ViT:
    ``visual.proj``; a linear-head ConvNeXt: ``head_proj``, a ModifiedResNet:
    the attention pool's ``c_proj``, each with its bias frozen);
  * loss = CE(100 * normalize(x @ P) @ text_weights, y)
           + lambda * sum((P - P_init)^2);
  * one optimizer step per epoch on the whole cached tensor, or chunked
    steps with lambda scaled by 1/num_chunks (``feat_batch_size``);
  * epoch e trains on cached view (e + 1) % V;
  * Adam(eps=1e-4) — the package's own, in optax's arithmetic — with the
    learning rate set per epoch by ``cosine_lr``;
  * the 7x7 (lr, lambda) grid search scored on the validation split: the
    49 projectors train together along a leading dimension (one batched
    product per step, as JAX vmaps them), then are scored in one pass.

Everything runs in fp32 on the features' device; TF32 is off, as in
``eval_transform``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LR_GRID = [1e-2, 1e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8]
LAMBDA_GRID = [10, 1, 0.1, 0.01, 0.001, 0.0001, 0]
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-4


def cosine_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """torch CosineAnnealingLR with eta_min=0, stepped per epoch."""
    if total_epochs <= 0:
        return base_lr
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))


def view_for_epoch(epoch: int, aug_views: int) -> int:
    """The reference's view-cycling counter reduces to (epoch+1) mod V."""
    return (epoch + 1) % max(aug_views, 1)


def _fp32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class ProjectorSpec:
    """The trainable projector: weight [pre_dim, embed_dim] fp32 and the
    frozen bias [embed_dim] (ConvNeXt ``head_proj``, the RN attention
    pool's ``c_proj``) or None."""

    weight: torch.Tensor
    bias: Optional[torch.Tensor]

    @staticmethod
    def from_clip_model(model) -> "ProjectorSpec":
        """The projector of a CLIP ``model`` (fp32 copies, its device)."""
        vis = model.visual
        cfg = model.config
        if cfg.is_vit:
            return ProjectorSpec(weight=vis.proj.detach().float().clone(),
                                 bias=None)
        if getattr(vis, "proj", None) == "mlp" or hasattr(vis, "head_fc1"):
            raise ValueError(
                "ProLIP projector tuning is undefined for MLP-head ConvNeXt "
                "variants (convnext_*_d): the projection is a 2-layer MLP, "
                "not a linear map over the cached pre-projection feature. "
                "Use a linear-head variant (convnext_base_w / "
                "convnext_xxlarge) or the PEFT path.")
        if hasattr(vis, "head_proj"):
            w = vis.head_proj.weight.detach().float().T.contiguous()
            hb = vis.head_proj.bias
            return ProjectorSpec(
                weight=w, bias=(hb.detach().float().clone() if hb is not None
                                else torch.zeros(w.shape[1], device=w.device)))
        # a ModifiedResNet: the attention pool's c_proj, its weight
        # trained and its bias frozen (JAX prolip.py:78-80)
        c_proj = vis.attnpool.c_proj
        return ProjectorSpec(
            weight=c_proj.weight.detach().float().T.contiguous(),
            bias=c_proj.bias.detach().float().clone())

    def to(self, device) -> "ProjectorSpec":
        return ProjectorSpec(
            self.weight.to(device),
            None if self.bias is None else self.bias.to(device))


class Adam:
    """Adam in optax's arithmetic (``scale_by_adam`` then the learning
    rate): mu, nu moments, bias correction by the step count, update =
    mu_hat / (sqrt(nu_hat) + eps), times -lr.  ``lr`` may be a tensor that
    broadcasts against the parameter (one rate per projector)."""

    def __init__(self, param: torch.Tensor, betas=ADAM_BETAS, eps=ADAM_EPS):
        self.b1, self.b2 = betas
        self.eps = eps
        self.mu = torch.zeros_like(param)
        self.nu = torch.zeros_like(param)
        self.count = 0

    def step(self, param: torch.Tensor, grad: torch.Tensor, lr) -> torch.Tensor:
        self.count += 1
        self.mu = (1 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1 - self.b2) * (grad * grad) + self.b2 * self.nu
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        mu_hat = self.mu / c1.to(param.device)
        nu_hat = self.nu / c2.to(param.device)
        return param + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + self.eps))


def _logits(weight, bias, x, text_weights):
    """[.., N, pre] @ [.., pre, emb] (+bias), L2-normalised, x 100 @ T."""
    feats = x @ weight
    if bias is not None:
        feats = feats + bias
    feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return 100.0 * feats @ text_weights


def _loss(weight, bias, x, y, valid, lam, text_weights, init_w):
    """Masked mean CE + lam * sum((W - W0)^2) over the last two axes; the
    sum over a leading (projector) axis of those losses when W has one."""
    logits = _logits(weight, bias, x, text_weights)
    logp = torch.log_softmax(logits, dim=-1)
    yy = y.long().expand(logits.shape[:-1])
    nll = -logp.gather(-1, yy[..., None])[..., 0]
    vf = valid.float()
    n_valid = vf.sum().clamp_min(1.0)
    ce = (nll * vf).sum(-1) / n_valid
    mse = ((weight - init_w) ** 2).sum((-2, -1))
    correct = ((logits.argmax(-1) == yy) & valid).sum(-1)
    return (ce + lam * mse), ce, mse, correct, n_valid


def _as_f32(a, device) -> torch.Tensor:
    """fp32 on ``device``; a fresh tensor, so an inference-mode tensor
    (the text head) may enter autograd."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).clone()
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def train_projector(views: List[np.ndarray], labels: np.ndarray,
                    text_weights, init_spec: ProjectorSpec, lr: float,
                    lam: float, epochs: int, feat_batch_size: int = 0,
                    verbose: bool = True, device=None
                    ) -> Tuple[ProjectorSpec, Dict]:
    """Run the ProLIP training loop on ``device`` (default: the
    projector's); returns (trained projector, stats)."""
    _fp32_matmuls()
    dev = torch.device(device) if device is not None else \
        init_spec.weight.device
    spec = init_spec.to(dev)
    aug_views = len(views)
    xs = [_as_f32(v, dev) for v in views]
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    tw = _as_f32(text_weights, dev)
    n = int(y.shape[0])
    init_w = spec.weight.float()
    weight = init_w.clone()
    opt = Adam(weight)
    chunked = bool(feat_batch_size and feat_batch_size > 0
                   and n > feat_batch_size)
    num_chunks = math.ceil(n / feat_batch_size) if chunked else 1
    lam_step = lam / float(max(num_chunks, 1)) if chunked else lam

    trail = []
    last_loss = None
    for epoch in range(epochs):
        x = xs[view_for_epoch(epoch, aug_views)]
        lr_e = cosine_lr(lr, epoch, epochs)
        lr_t = torch.tensor(lr_e, dtype=torch.float32, device=dev)
        sums = torch.zeros(4, device=dev)   # correct, seen, ce, mse
        if chunked:
            chunks = []
            for start in range(0, n, feat_batch_size):
                k = min(feat_batch_size, n - start)
                if k < feat_batch_size:
                    # the static chunk shape: the LAST B rows, the overlap
                    # with the previous chunk masked out
                    sl = slice(n - feat_batch_size, n)
                    valid = torch.arange(feat_batch_size, device=dev) >= (
                        feat_batch_size - k)
                else:
                    sl = slice(start, start + k)
                    valid = torch.ones(k, dtype=torch.bool, device=dev)
                chunks.append((sl, valid))
        else:
            chunks = [(slice(0, n), torch.ones(n, dtype=torch.bool,
                                               device=dev))]
        for sl, valid in chunks:
            w = weight.detach().requires_grad_(True)
            loss, ce, mse, correct, nv = _loss(
                w, spec.bias, x[sl], y[sl], valid, lam_step, tw, init_w)
            (grad,) = torch.autograd.grad(loss, w)
            weight = opt.step(weight, grad, lr_t)
            sums += torch.stack([correct.float(), nv, ce.detach(),
                                 mse.detach()])
            last_loss = loss.detach()
        trail.append((sums, lr_e))

    stats: Dict = {"epochs": []}
    for epoch, (sums, lr_e) in enumerate(trail):
        correct, seen, ce, mse = sums.tolist()
        s = {"acc": correct / max(seen, 1), "ce": ce / num_chunks,
             "mse": mse / num_chunks, "lr": lr_e}
        stats["epochs"].append(s)
        if verbose:
            print(f"Train Epoch: {epoch} / {epochs}  Acc: {s['acc']:.4f}, "
                  f"Loss_ce: {s['ce']:.4f}, Loss_mse: {s['mse']:.4f}, "
                  f"lr: {lr_e:.2e}")
    stats["final_loss"] = None if last_loss is None else float(last_loss)
    return ProjectorSpec(weight=weight.detach(), bias=spec.bias), stats


@torch.no_grad()
def _predict_top1(spec: ProjectorSpec, feats: torch.Tensor,
                  text_weights: torch.Tensor) -> torch.Tensor:
    return _logits(spec.weight, spec.bias, feats.float(),
                   text_weights).argmax(-1)


def projector_accuracy(proj: ProjectorSpec, feats, labels,
                       text_weights) -> float:
    """Top-1 accuracy (%) of projected, normalised features against the
    text head, on the projector's device."""
    _fp32_matmuls()
    dev = proj.weight.device
    preds = _predict_top1(proj, _as_f32(feats, dev),
                          _as_f32(text_weights, dev)).cpu().numpy()
    return float((preds == np.asarray(labels)).mean() * 100.0)


def grid_train(views: List[np.ndarray], labels: np.ndarray, text_weights,
               init_spec: ProjectorSpec, lrs, lams, epochs: int,
               device=None) -> torch.Tensor:
    """Train K projectors, one per (lrs[k], lams[k]), full batch, together:
    weights [K, pre, emb] and one batched product per step.  Each equals
    ``train_projector`` with that pair."""
    _fp32_matmuls()
    dev = torch.device(device) if device is not None else \
        init_spec.weight.device
    spec = init_spec.to(dev)
    aug_views = len(views)
    xs = [_as_f32(v, dev) for v in views]
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    tw = _as_f32(text_weights, dev)
    lrs_t = torch.tensor(lrs, dtype=torch.float32, device=dev)[:, None, None]
    lams_t = torch.tensor(lams, dtype=torch.float32, device=dev)
    k = lrs_t.shape[0]
    init_w = spec.weight.float()
    weight = init_w.expand(k, *init_w.shape).clone()
    valid = torch.ones(y.shape[0], dtype=torch.bool, device=dev)
    opt = Adam(weight)
    for epoch in range(epochs):
        x = xs[view_for_epoch(epoch, aug_views)]
        factor = cosine_lr(1.0, epoch, epochs)
        w = weight.detach().requires_grad_(True)
        loss = _loss(w, spec.bias, x, y, valid, lams_t, tw, init_w)[0]
        (grad,) = torch.autograd.grad(loss.sum(), w)
        weight = opt.step(weight, grad, lrs_t * factor)
    return weight.detach()


@torch.no_grad()
def score_projectors(weights: torch.Tensor, bias, val_feats, val_labels,
                     text_weights) -> np.ndarray:
    """Validation top-1 (%) of each projector: weights [K, pre, emb]."""
    dev = weights.device
    logits = _logits(weights, bias, _as_f32(val_feats, dev),
                     _as_f32(text_weights, dev))
    vl = torch.from_numpy(np.asarray(val_labels, np.int64)).to(dev)
    return ((logits.argmax(-1) == vl).float().mean(-1) * 100.0).cpu().numpy()


def grid_search(views: List[np.ndarray], labels: np.ndarray, text_weights,
                init_spec: ProjectorSpec, val_feats: np.ndarray,
                val_labels: np.ndarray, epochs: int, lr_grid=LR_GRID,
                lambda_grid=LAMBDA_GRID, verbose: bool = True, device=None,
                return_accs: bool = False):
    """(lr, lambda) grid search scored by validation accuracy; returns
    (lr, lambda, best val accuracy[, the accuracies of all pairs]).  The
    grid trains together at full batch (``grid_train``), whatever
    ``feat_batch_size`` says: the reference's search has no chunking."""
    if verbose:
        print("**** Searching for best lr **** \n")
    combos = [(lr, lam) for lr in lr_grid for lam in lambda_grid]
    weights = grid_train(views, labels, text_weights, init_spec,
                         [c[0] for c in combos], [c[1] for c in combos],
                         epochs, device=device)
    bias = None if init_spec.bias is None else \
        init_spec.bias.to(weights.device)
    accs = score_projectors(weights, bias, val_feats, val_labels,
                            text_weights)
    if verbose:
        for (lr, lam), acc in zip(combos, accs):
            print(f"lr={lr:g} lambda={lam:g} val_acc={acc:.4f}")
    best = int(np.argmax(accs))
    out = (combos[best][0], combos[best][1], float(accs[best]))
    return out + (accs,) if return_accs else out


def evaluate_multi_testsets(proj: ProjectorSpec, encode_split,
                            test_views: Dict[str, object],
                            text_weights_map: Dict[str, object],
                            default_weights) -> Dict[str, float]:
    """The trained projector on several named test sets, each with its own
    (optional) text head."""
    out: Dict[str, float] = {}
    for name, view in test_views.items():
        if view is None:
            out[name] = 0.0
            continue
        feats, labels = encode_split(view)
        weights = text_weights_map.get(name, default_weights)
        out[name] = projector_accuracy(proj, feats, labels, weights)
    return out


def resolve_lambda(cfg, shots: int) -> float:
    """lambda schedules: 1/N, 1/N^2, or the configured fallback."""
    if cfg.get("lambda_funct_1_N", False):
        return 1.0 / max(shots, 1)
    if cfg.get("lambda_funct_1_N2", False):
        return 1.0 / max(shots, 1) ** 2
    return float(cfg.get("lambda_v", 0.1))
