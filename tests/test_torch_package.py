"""The PyTorch port stands alone: importing it pulls in no JAX, no flax,
nothing of ``aihab_clip_tpu``, and none of the host libraries the card's
machine lacks (yaml, pandas, scikit-learn, cv2, PIL, optax, orbax,
tensorstore, transformers, tokenizers, safetensors, open_clip); ``wandb``, ``matplotlib`` and ``seaborn`` are imported only
inside a function, at use (the logger's guarded imports), never at a
module's import; its entry points refuse a missing card."""

import ast
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "aihab_clip_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "aihab_clip_tpu", "yaml", "pandas",
             "sklearn", "cv2", "PIL", "optax", "orbax", "tensorstore",
             "zstandard", "lz4", "transformers", "tokenizers", "safetensors",
             "open_clip"}
# optional at run time: imported inside a function only, behind a guard
GUARDED = {"wandb", "matplotlib", "seaborn"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN | GUARDED!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", [
    "aihab_clip_tpu_torch.parallel", "aihab_clip_tpu_torch.parallel.comm",
    "aihab_clip_tpu_torch.parallel.pipeline",
    "aihab_clip_tpu_torch.train.pipeline_peft",
    "aihab_clip_tpu_torch.tools.dryrun_multichip"])
def test_parallel_modules_leave_jax_out(module):
    """The parallel paths, imported alone, pull in no JAX and nothing of
    the JAX package."""
    assert module in MODULES
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\nprint(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parallel_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from aihab_clip_tpu_torch.parallel.distributed import (
        initialize_distributed, local_device)
    from aihab_clip_tpu_torch.tools import dryrun_multichip

    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip.main([])


def _imports(tree):
    """(import node, names, inside a function) for every import."""
    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                yield child, [a.name for a in child.names], in_fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child, [child.module or ""], in_fn
            yield from walk(child, fn)

    return walk(tree, False)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node, names, in_fn in _imports(tree):
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (
                f"{path}:{node.lineno} imports {name}")
            assert top not in GUARDED or in_fn, (
                f"{path}:{node.lineno} imports {name} outside a function")


def test_entry_points_refuse_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from aihab_clip_tpu_torch.backend import resolve_device
    from aihab_clip_tpu_torch.models import load
    from aihab_clip_tpu_torch.serving import ClassifierEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        load("random:Tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierEngine(model="random:Tiny", batch_size=2, verbose=False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_unported_options_raise():
    from aihab_clip_tpu_torch.serving import ClassifierEngine

    # int8 serves CLIP ViT towers too (K8 + K14), from weights quantized once
    engine = ClassifierEngine(model="random:Tiny", quantize="int8",
                              device="cpu", verbose=False)
    assert engine._packed is None
    assert len(engine._qparams["transformer"]) == 2
    # LoRA serves W_eff: adapters whose B is zero (a fresh lora_init) leave
    # the engine's answers as they were
    from aihab_clip_tpu_torch.models.convert import port_adapters_to_flax
    from aihab_clip_tpu_torch.train.lora import lora_init

    plain = ClassifierEngine(model="random:Tiny", device="cpu", verbose=False)
    adapters = lora_init(plain.bundle.model, 2, torch.Generator())
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/lora_adapters.npz"
        np.savez(path, **port_adapters_to_flax(adapters))
        merged = ClassifierEngine(model="random:Tiny", lora=path,
                                  device="cpu", verbose=False)
    imgs = np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3),
                                             dtype=np.uint8)
    np.testing.assert_array_equal(merged.classify_batch(imgs),
                                  plain.classify_batch(imgs))
