"""aihab-clip-tpu-torch: the PyTorch + CUDA (Hopper) port of ``aihab_clip_tpu``.

A package of its own beside the JAX one, which stays the reference: it
imports ``torch`` and ``numpy``, never ``jax`` nor anything of
``aihab_clip_tpu``, and keeps its own copies of the host-side modules.
Module names mirror the JAX package so each counterpart is easy to find.

  backend       explicit device resolution (no silent CPU fallback)
  taxonomy      L3/L2 habitat label spaces (copy)
  templates     prompt ensembles (copy)
  tokenizer     byte-level CLIP BPE, pure Python
  models        CLIP ViT + text towers and SigLIP (nn.Module), weight
                carry from the JAX package's npz layout, zoo, text head,
                fast ViT and SigLIP encodes
  ops           eval preprocessing; the hand-written CUDA block kernels
  serving       ClassifierEngine + DynamicBatcher

Entry points (``models.zoo.load``, ``serving.ClassifierEngine``) run on the
card by default (``device="cuda"``) and raise when none is present unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
