"""The PyTorch port stands alone: importing it pulls in no JAX, no flax,
nothing of ``aihab_clip_tpu``, and none of the host libraries the card's
machine lacks (yaml, pandas, scikit-learn, cv2, PIL, optax, orbax, wandb,
tensorstore); its entry points refuse a missing card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "aihab_clip_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "aihab_clip_tpu", "yaml", "pandas",
             "sklearn", "cv2", "PIL", "optax", "orbax", "wandb",
             "tensorstore"}
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def test_import_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path}:{node.lineno} imports {name}")


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
    with pytest.raises(NotImplementedError, match="LoRA"):
        ClassifierEngine(model="random:Tiny", lora="x.npz", device="cpu")
