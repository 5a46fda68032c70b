from .clip import CLIP_ARCHS, CLIPConfig, CLIPModel
from .text_head import build_text_head, classifier_logits, compute_text_weights
from .zoo import CLIPBundle, load

__all__ = [
    "CLIP_ARCHS",
    "CLIPBundle",
    "CLIPConfig",
    "CLIPModel",
    "build_text_head",
    "classifier_logits",
    "compute_text_weights",
    "load",
]
