"""device_idle_share.train: ``readers.device_idle_share`` in the fine-tune cell."""

from benchmark.readers import device_idle_share as read  # noqa: F401
