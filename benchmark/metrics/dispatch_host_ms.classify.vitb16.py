"""dispatch_host_ms.classify.vitb16: ``readers.dispatch_host_ms`` in the ViT-B/16 classify cell."""

from benchmark.readers import dispatch_host_ms as read  # noqa: F401
