"""attention_roofline.classify.vitb16: ``readers.classify_attention_roofline`` in the ViT-B/16 classify cell."""

from benchmark.readers import classify_attention_roofline as read  # noqa: F401
