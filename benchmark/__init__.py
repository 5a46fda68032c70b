"""The benchmark of the PyTorch and CUDA port (``aihab_clip_tpu_torch``) on
one H100: ``python3 -m benchmark.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>``.  See ``harness.py`` for how a cell's files are found."""
