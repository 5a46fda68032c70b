"""device_idle_share.classify.vitb16: ``readers.device_idle_share`` in the ViT-B/16 classify cell."""

from benchmark.readers import device_idle_share as read  # noqa: F401
