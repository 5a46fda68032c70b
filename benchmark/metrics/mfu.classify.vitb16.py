"""mfu.classify.vitb16: ``readers.classify_mfu`` in the ViT-B/16 classify cell."""

from benchmark.readers import classify_mfu as read  # noqa: F401
