"""aihab-clip-tpu-torch: the PyTorch + CUDA (Hopper) port of ``aihab_clip_tpu``.

A package of its own beside the JAX one, which stays the reference: it
imports ``torch`` and ``numpy``, never ``jax`` nor anything of
``aihab_clip_tpu``, and keeps its own copies of the host-side modules.
Module names mirror the JAX package so each counterpart is easy to find.

  backend       explicit device resolution (no silent CPU fallback)
  config        two-layer YAML config (its own YAML reader), --opts overrides
  runner        config -> model + text head -> loaders -> feature cache ->
                ProLIP (openai backend) or PEFT (openclip); ``python -m
                aihab_clip_tpu_torch`` is its CLI
  data          CSV index, stratified-group splits, JPEG/PNG decode and a
                JPEG encoder in numpy, bulk loader, loaders, synthetic CS tree
  cache         the pre-projection feature cache and the embedding cache
  utils         the run logger, projector checkpoints
  taxonomy      L3/L2 habitat label spaces (copy)
  templates     prompt ensembles (copy)
  tokenizer     byte-level CLIP BPE, pure Python; a HF snapshot's
                tokenizer.json (hf_json)
  models        CLIP ViT + text towers and SigLIP (nn.Module), weight
                carry from OpenAI/open_clip checkpoints, HF SigLIP
                snapshots (its own safetensors reader) and the JAX
                package's npz layout both ways, zoo, text head, fast ViT
                and SigLIP encodes
  ops           eval preprocessing; the hand-written CUDA block kernels
  serving       ClassifierEngine + DynamicBatcher
  train         PEFT finetune, ProLIP, evaluation

Entry points (``models.zoo.load``, ``serving.ClassifierEngine``,
``runner.run`` and the CLI) run on the card by default (``device="cuda"``)
and raise when none is present unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
