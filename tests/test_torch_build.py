"""The kernel build's cache keys (``ops/_build.py``), on the CPU: a library
is named by the hash of its source and of every header in ``csrc/``, so a
changed or added header rebuilds it, and another source's edit does not."""

import shutil

from aihab_clip_tpu_torch.ops import _build


def test_library_path_keys_every_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build._library_path("block_kernels")
    assert first.parent == tmp_path / "build"
    assert first.name.startswith("block_kernels-") and first.suffix == ".so"
    assert _build._library_path("block_kernels") == first  # deterministic

    (csrc / "preprocess.cu").write_text("// another source\n")
    assert _build._library_path("block_kernels") == first

    seen = {first}
    for header in ("hopper.cuh", "common.cuh"):
        with open(csrc / header, "a") as f:
            f.write("\n// edited\n")
        path = _build._library_path("block_kernels")
        assert path not in seen, header
        seen.add(path)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._library_path("block_kernels") not in seen


def test_every_entry_point_has_its_source():
    """Each C entry point's argument types name a source that is built."""
    assert set(_build._ARGTYPES) == set(_build.SOURCES)
    for fn in ("aihab_ln_gemm", "aihab_gemm_residual", "aihab_attention",
               "aihab_fused_attention_fwd", "aihab_gemm_plan",
               "aihab_flash_plan"):
        assert _build._SOURCE_OF[fn] == "block_kernels"
