"""device_idle_share.serve: ``readers.device_idle_share`` in the serving cell."""

from benchmark.readers import device_idle_share as read  # noqa: F401
