"""attention_roofline.classify.so400m: ``readers.classify_attention_roofline`` in the SO400M classify cell."""

from benchmark.readers import classify_attention_roofline as read  # noqa: F401
