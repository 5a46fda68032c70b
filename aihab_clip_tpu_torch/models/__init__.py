from .clip import CLIP_ARCHS, CLIPConfig, CLIPModel
from .siglip import (SIGLIP_ARCHS, SigLIPConfig, SigLIPModel,
                     siglip_config_for_name, siglip_normalize_stats)
from .text_head import build_text_head, classifier_logits, compute_text_weights
from .zoo import CLIPBundle, SigLIPAssetsMissingError, load

__all__ = [
    "CLIP_ARCHS",
    "CLIPBundle",
    "CLIPConfig",
    "CLIPModel",
    "SIGLIP_ARCHS",
    "SigLIPAssetsMissingError",
    "SigLIPConfig",
    "SigLIPModel",
    "build_text_head",
    "classifier_logits",
    "compute_text_weights",
    "load",
    "siglip_config_for_name",
    "siglip_normalize_stats",
]
