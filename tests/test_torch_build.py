"""The kernel build's cache keys (``ops/_build.py``), on the CPU: a library
is named by the hash of its source and of every header in ``csrc/``, so a
changed or added header rebuilds it, and another source's edit does not."""

import shutil

import pytest

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
    for fn in ("aihab_fused_attention_bwd", "aihab_fused_attention_bwd_plan"):
        assert _build._SOURCE_OF[fn] == "fused_attention_bwd"
    for fn in ("aihab_row_quant", "aihab_int8_gemm", "aihab_int8_gemm_plan"):
        assert _build._SOURCE_OF[fn] == "quant_kernels"


def test_plan_entry_points_take_an_output_pointer():
    """The plan functions fill an int array: their last argument is a
    pointer, the ones before it ints (the shape, groups, residual, kind)."""
    plans = {"aihab_gemm_plan": 3, "aihab_flash_plan": 5,
             "aihab_fused_attention_bwd_plan": 4, "aihab_int8_gemm_plan": 5}
    for fn, n_ints in plans.items():
        args = _build._ARGTYPES[_build._SOURCE_OF[fn]][fn]
        assert args == [_build._i] * n_ints + [_build._p], fn


@pytest.mark.parametrize("source", ["block_kernels", "fused_attention_bwd",
                                    "quant_kernels"])
def test_tma_sources_include_and_key_the_hopper_header(source, tmp_path,
                                                       monkeypatch):
    """The TMA + wgmma sources include hopper.cuh, and an edit of it gives
    each of them a new library name (a stale build is never served)."""
    text = (_build._CSRC / f"{source}.cu").read_text()
    assert '#include "hopper.cuh"' in text
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build._library_path(source)
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build._library_path(source) != before


def test_normalised_p_attention_is_a_flash_instance():
    """K12's and K14's attention is the flash kernel's NORM_P instance, built
    for every head width the dispatch takes; the WMMA kernel and its tile
    helpers are gone from every source."""
    block = (_build._CSRC / "block_kernels.cu").read_text()
    assert "template <int HD, typename TO, bool NORM_P>" in block
    assert "launch_flash<HD, float, true>" in block
    assert "flash_attention_kernel<HD, float, true>" in block   # its plan
    for d in (64, 72, 88, 104):
        assert f"case {d}: return f(std::integral_constant<int, {d}>());" \
            in block
    for path in sorted(_build._CSRC.iterdir()):
        text = path.read_text()
        for gone in ("attention_norm_p_kernel", "AttnTile", "wmma::",
                     "<mma.h>"):
            assert gone not in text, (path.name, gone)


def test_quantized_output_mode_is_built():
    """The int8 GEMM's quantized output is an instance of the one kernel,
    reached through its own entry point and reported by the plan."""
    quant = (_build._CSRC / "quant_kernels.cu").read_text()
    assert "typename TO, bool QOUT>" in quant
    assert "launch_int8_gemm<false, false, bf16, float, true>" in quant
    assert "int8_gemm_kernel<false, false, bf16, float, true>" in quant
    assert "atomicMax(" in quant and "ld.acquire.gpu" in quant
    assert _build._SOURCE_OF["aihab_int8_gemm_qout"] == "quant_kernels"
    args = _build._ARGTYPES["quant_kernels"]["aihab_int8_gemm_qout"]
    assert len(args) == 16 and args[-1] == _build._p
