"""dispatch_host_ms.classify.so400m: ``readers.dispatch_host_ms`` in the SO400M classify cell."""

from benchmark.readers import dispatch_host_ms as read  # noqa: F401
