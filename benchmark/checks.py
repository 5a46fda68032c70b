"""The comparisons that decide ``correct``, against the plain reference
(``reference/``), which imports nothing of the program and takes nothing it
made: the weights are drawn again from the seed, the prompts tokenised by
the reference's own copy of the BPE, the text head and the eval transform
worked out again.  What the program made is judged, never used to make the
reference's numbers: its answers, and in the classify cells the text head
every answer was read through, held to the reference's own.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from .reference import clip_bpe, towers

PROMPTS = Path(__file__).resolve().parent / "reference" / "cs_prompts.json"


def prompt_tokens(cfg: dict, device) -> tuple:
    """The class prompts as the reference tokenises them, with the class
    and template counts."""
    p = json.loads(PROMPTS.read_text())
    ids = clip_bpe.tokenize(p["prompts"], cfg["text"]["max_position_embeddings"])
    return (torch.from_numpy(ids).to(device), len(p["classes"]),
            p["templates_per_class"])


def reference_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights again, as float32."""
    weights = towers.make_weights(cfg, seed, device)
    return {k: v.float() for k, v in weights.items()}


@torch.no_grad()
def reference_answers(cfg: dict, seed: int, images_u8: torch.Tensor, device,
                      chunk: int = 16, lowered: bool = False):
    """The reference's normalised image features [n, E] and its text head
    [E, C] (both on the host) of uint8 images [n, D, D, 3]; ``lowered``:
    the control's (``towers.Lowered``, float8)."""
    towers.full_fp32()
    params = reference_params(cfg, seed, device)
    if lowered:
        params = towers.Lowered(params)
    tokens, n_cls, per = prompt_tokens(cfg, device)
    head = towers.text_head(tokens, params, cfg, n_cls, per)
    feats = []
    for i in range(0, len(images_u8), chunk):
        x = towers.eval_transform(images_u8[i:i + chunk].to(device), cfg)
        feats.append(towers.l2n(towers.image_features(x, params, cfg)))
    return torch.cat(feats).cpu(), head.cpu()


def answers(feats: torch.Tensor, head: torch.Tensor) -> np.ndarray:
    """Class probabilities of normalised features under a text head."""
    return torch.softmax(100.0 * feats @ head, -1).numpy()


def centred(z: torch.Tensor) -> torch.Tensor:
    z = z.double()
    return z - z.mean(-1, keepdim=True)


def centred_log(probs: torch.Tensor) -> torch.Tensor:
    """log p less its mean over the classes: the logits up to nothing."""
    return centred(torch.log(probs.double()))


def compare_classify(probs: np.ndarray, feats: torch.Tensor,
                     head: torch.Tensor, prog_head: torch.Tensor
                     ) -> Dict[str, float]:
    """The program's probabilities [n, C] against the reference (its image
    features ``feats`` and its text head ``head``):

    * ``logit_gap`` / ``logit_rms``: the widest gap of a centred logit
      over the sample, and its root mean square, against the reference's
      logits: everything the answers carry;
    * ``text_gap``: the program's text head ``prog_head`` (what every
      answer is read through, set up once) against the reference's, the
      worst class's relative gap;
    * ``image_gap`` / ``image_rms``: the answers against the reference's
      image features read through the program's text head: the towers'
      own part of the gap.  A text head in bfloat16 is about 1% off, the
      same in every engine, and that part would hide a tower's error
      under it in the first two (PERF.md)."""
    got = centred_log(torch.from_numpy(np.asarray(probs)))
    feats = feats.double()
    head, prog_head = head.double(), prog_head.double()
    diff = got - centred(100.0 * feats @ head)
    own = got - centred(100.0 * feats @ prog_head)
    text = ((prog_head - head).norm(dim=0) / head.norm(dim=0)).max()
    out = {"logit_gap": diff.abs().max(), "logit_rms": diff.pow(2).mean().sqrt(),
           "text_gap": text, "image_gap": own.abs().max(),
           "image_rms": own.pow(2).mean().sqrt()}
    return {k: float(v) if torch.isfinite(v) else math.inf
            for k, v in out.items()}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], names):
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    med = float(np.median([want[n] for n in names]))
    gaps = []
    for n in names:
        gap = abs(got.get(n, math.nan) - want[n]) / max(want[n], med, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def counted_leaves(ref: dict):
    """The leaves the leaf numbers count: all but those whose reference
    gradient is below a thousandth of the median leaf's (under softmax a
    key's bias gets none, and Adam then moves it by round-off alone)."""
    med = float(np.median(list(ref["first_grad"].values())))
    return [n for n, g in ref["first_grad"].items() if g >= 1e-3 * med]


def compare_train(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number of the checked steps: ``loss_gap_<i>``, step i's
    relative loss gap; ``grad_gap`` and ``change_gap`` (and their
    ``_median``), the worst (the median) leaf's gap between the program's
    norm and the reference's, of the first gradient as Adam got it and of
    the change after the steps; ``grad_diff`` (``_median``), the worst (the
    median) leaf's norm of the first gradients' difference, over the same
    base, and ``grad_diff_visual`` (``_median``) the same over the vision
    tower's leaves.  Which are compared is the cell's limits file's choice
    (``PERF.md`` gives every reading and why)."""
    if set(prog["trainable"]) != set(ref["trainable"]) or len(
            prog["losses"]) != len(ref["losses"]):
        return {"grad_diff": math.inf, "change_gap": math.inf}
    names = counted_leaves(ref)
    out = {f"loss_gap_{i + 1}": abs(a - b) / abs(b) if math.isfinite(a)
           else math.inf
           for i, (a, b) in enumerate(zip(prog["losses"], ref["losses"]))}
    med = float(np.median([ref["first_grad"][n] for n in names]))
    diff = [float((prog["grads"][n] - ref["grads"][n]).norm())
            / max(ref["first_grad"][n], med, 1e-30) for n in names]
    for key, gaps in (
            ("grad_gap", _leaf_gaps(prog["first_grad"], ref["first_grad"],
                                    names)),
            ("change_gap", _leaf_gaps(prog["change"], ref["change"], names)),
            ("grad_diff", diff)):
        out[key] = max(gaps)
        out[f"{key}_median"] = float(np.median(gaps))
    # the vision tower's leaves alone: a frozen prefix's error reaches the
    # gradients through them first
    visual = [d for n, d in zip(names, diff) if n.startswith("visual.")]
    if visual:
        out["grad_diff_visual"] = max(visual)
        out["grad_diff_visual_median"] = float(np.median(visual))
    return out
