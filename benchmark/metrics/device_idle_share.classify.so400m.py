"""device_idle_share.classify.so400m: ``readers.device_idle_share`` in the SO400M classify cell."""

from benchmark.readers import device_idle_share as read  # noqa: F401
