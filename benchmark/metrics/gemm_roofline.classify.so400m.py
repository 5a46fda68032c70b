"""gemm_roofline.classify.so400m: ``readers.classify_gemm_roofline`` in the SO400M classify cell."""

from benchmark.readers import classify_gemm_roofline as read  # noqa: F401
