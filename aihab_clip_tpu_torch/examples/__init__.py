"""Runnable examples of the port (counterparts of the repository's root
``examples/``): ``python -m aihab_clip_tpu_torch.examples.<name>
[--device cuda|cpu]``."""
