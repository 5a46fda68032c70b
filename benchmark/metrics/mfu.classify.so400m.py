"""mfu.classify.so400m: ``readers.classify_mfu`` in the SO400M classify cell."""

from benchmark.readers import classify_mfu as read  # noqa: F401
