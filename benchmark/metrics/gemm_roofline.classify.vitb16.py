"""gemm_roofline.classify.vitb16: ``readers.classify_gemm_roofline`` in the ViT-B/16 classify cell."""

from benchmark.readers import classify_gemm_roofline as read  # noqa: F401
