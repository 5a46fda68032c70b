"""``tools/sass_diff.py``'s kernel naming, on the CPU (the SASS itself needs
``nvcc``): parameter lists are dropped, and a kernel that appended a
template flag is matched with the parent kernel it extends, its flag-off
instance where it has several."""

import pytest

from aihab_clip_tpu_torch.tools import sass_diff as sd

NS = "(anonymous namespace)::"


@pytest.mark.parametrize("name,key", [
    (NS + "gemm_kernel<(Epi)2, false>(CUtensorMap, float const*, int)",
     NS + "gemm_kernel<(Epi)2, false>"),
    ("act_pass(float*, int)", "act_pass"),
    (NS + "ln_rows_kernel", NS + "ln_rows_kernel"),
])
def test_kernel_key_drops_the_parameter_list(name, key):
    assert sd.kernel_key(name) == key


@pytest.mark.parametrize("key,cut", [
    (NS + "flash_attention_kernel<64, __nv_bfloat16, false>",
     (NS + "flash_attention_kernel<64, __nv_bfloat16>", "false")),
    (NS + "k<(anonymous namespace)::Tag<1, 2>, 3>",
     (NS + "k<(anonymous namespace)::Tag<1, 2>>", "3")),
    (NS + "k<(Epi)2, false>", (NS + "k<(Epi)2>", "false")),
    (NS + "k<64>", None),
    (NS + "k", None),
])
def test_split_last_arg(key, cut):
    assert sd.split_last_arg(key) == cut


def test_appended_flag_matches_its_flag_off_instance():
    f = NS + "flash_attention_kernel<{}>"
    q = NS + "int8_gemm_kernel<false, false, float, float{}>"
    parent = {f.format("64, bf16"): "a", f.format("72, bf16"): "b",
              q.format(""): "c", NS + "gone": "d"}
    change = {f.format("64, bf16, false"): "a", f.format("64, bf16, true"): "x",
              f.format("72, bf16, false"): "b2", q.format(", false"): "c",
              NS + "new<1, 2>": "n"}
    out, renamed = sd.match_appended_flags(parent, change)
    assert out == {f.format("64, bf16"): "a", f.format("64, bf16, true"): "x",
                   f.format("72, bf16"): "b2", q.format(""): "c",
                   NS + "new<1, 2>": "n"}
    assert renamed == {f.format("64, bf16"): f.format("64, bf16, false"),
                       f.format("72, bf16"): f.format("72, bf16, false"),
                       q.format(""): q.format(", false")}


def test_a_surviving_parent_name_is_not_matched_again():
    """Where the change still has the parent's kernel, a longer instance is
    a kernel of its own; where no instance reads false, none is chosen."""
    parent = {"k<1>": "a", "j<1>": "b"}
    change = {"k<1>": "a", "k<1, false>": "x", "j<1, 2>": "y", "j<1, 3>": "z"}
    out, renamed = sd.match_appended_flags(parent, change)
    assert out == change and renamed == {}
