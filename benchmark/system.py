"""The system under test: the port's entry points, given the benchmark's
seeded weights.

``ClassifierEngine`` loads its model by name through the zoo
(``aihab_clip_tpu_torch.models.load``).  The benchmark hands it the seeded
weights already on the card by answering that one call with a bundle built
from them, so no 2.3 GB file is written and no CPU draw is made in every
run; everything the engine derives from the model (the text head, the
kernels' weight pack, the int8 weights) it derives itself.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def port_config(cfg: dict):
    """The port's config of a benchmark configuration file."""
    from aihab_clip_tpu_torch.models import CLIPConfig, SigLIPConfig

    v, t = cfg["vision"], cfg["text"]
    if cfg["family"] == "siglip":
        return SigLIPConfig(
            embed_dim=cfg["embed_dim"], image_resolution=v["image_size"],
            patch_size=v["patch_size"], vision_width=v["hidden_size"],
            vision_layers=v["num_hidden_layers"],
            vision_heads=v["num_attention_heads"],
            vision_mlp_dim=v["intermediate_size"],
            context_length=t["max_position_embeddings"],
            vocab_size=t["vocab_size"], text_width=t["hidden_size"],
            text_layers=t["num_hidden_layers"],
            text_heads=t["num_attention_heads"],
            text_mlp_dim=t["intermediate_size"])
    heads = v["num_attention_heads"]
    return CLIPConfig(
        embed_dim=cfg["embed_dim"], image_resolution=v["image_size"],
        vision_layers=v["num_hidden_layers"], vision_width=v["hidden_size"],
        vision_patch_size=v["patch_size"],
        context_length=t["max_position_embeddings"],
        vocab_size=t["vocab_size"], transformer_width=t["hidden_size"],
        transformer_heads=t["num_attention_heads"],
        transformer_layers=t["num_hidden_layers"],
        vision_mlp_dim=v["intermediate_size"],
        text_mlp_dim=t["intermediate_size"],
        vision_heads_override=(0 if heads == v["hidden_size"] // 64
                               else heads),
        act=v["hidden_act"])


def port_model(cfg: dict, weights: Dict[str, torch.Tensor], device,
               compute_dtype):
    """The port's model holding ``weights`` as float32 parameters (the
    port keeps its parameters in float32 whatever the checkpoint's dtype)
    and computing in ``compute_dtype``."""
    from aihab_clip_tpu_torch.models import CLIPModel, SigLIPModel

    pcfg = port_config(cfg)
    cls = SigLIPModel if cfg["family"] == "siglip" else CLIPModel
    with torch.device("meta"):
        model = cls(pcfg, dtype=compute_dtype)
    state = {name: w.to(device, torch.float32) for name, w in weights.items()}
    model.load_state_dict(state, assign=True)
    return model.to(device).eval(), pcfg


@contextlib.contextmanager
def _zoo_answers(bundle):
    """The zoo's ``load`` answers with ``bundle`` inside the block; an
    engine that does not ask for it is an error."""
    import aihab_clip_tpu_torch.models as models

    asked = []

    def load(name, dtype=torch.float32, device="cuda", **_):
        asked.append(name)
        if dtype != bundle.model.visual.dtype:
            raise ValueError(f"engine asked for {dtype}, bundle computes in "
                             f"{bundle.model.visual.dtype}")
        return bundle

    original = models.load
    models.load = load
    try:
        yield
    finally:
        models.load = original
    if not asked:
        raise RuntimeError("the engine loaded its model without the zoo's "
                           "load; the seeded weights did not reach it")


def classifier_engine(cfg: dict, weights, *, batch_size: int, buckets: int,
                      quantize: str, device):
    """``ClassifierEngine`` over the seeded weights."""
    from aihab_clip_tpu_torch.models import CLIPBundle
    from aihab_clip_tpu_torch.serving import ClassifierEngine

    dev = torch.device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model, pcfg = port_model(cfg, weights, dev, dtype)
    bundle = CLIPBundle(cfg["name"], pcfg, model, "random", None)
    del model
    with _zoo_answers(bundle):
        return ClassifierEngine(cfg["name"], batch_size=batch_size,
                                buckets=buckets, quantize=quantize,
                                verbose=False, device=dev)
