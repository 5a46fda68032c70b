"""The port's tokenizer, taxonomy and templates equal the JAX package's."""

import sys
from functools import lru_cache

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import aihab_clip_tpu.taxonomy as jax_taxonomy
import aihab_clip_tpu.templates as jax_templates
from aihab_clip_tpu.tokenizer.bpe import ClipBPETokenizer as JaxTokenizer

import aihab_clip_tpu_torch.taxonomy as taxonomy
import aihab_clip_tpu_torch.templates as templates
from aihab_clip_tpu_torch.tokenizer import ClipBPETokenizer, tokenize


@lru_cache()
def _pair():
    return JaxTokenizer(use_native=False), ClipBPETokenizer()


MODES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("hier,desc", MODES)
def test_prompt_ids_match(hier, desc):
    ref, tok = _pair()
    prompts, tpc = templates.gen_prompts(use_hierarchy=hier,
                                         use_descriptive=desc)
    assert (prompts, tpc) == jax_templates.gen_prompts(use_hierarchy=hier,
                                                       use_descriptive=desc)
    assert len(prompts) == 20 * tpc and all(p.isascii() for p in prompts)
    for p in prompts:
        assert tok.encode(p) == ref.encode(p), p
    arr = tokenize(prompts, truncate=True)
    for row, p in zip(arr, prompts):
        ids = ([ref.sot_id] + ref.encode(p) + [ref.eot_id])[:77]
        ids[-1] = ref.eot_id
        assert row[:len(ids)].tolist() == ids and not row[len(ids):].any()


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.characters(max_codepoint=127), max_size=80))
def test_ascii_text_ids_match(text):
    ref, tok = _pair()
    assert tok.encode(text) == ref.encode(text)


def test_unicode_text_uses_regex_or_raises(monkeypatch):
    ref, tok = _pair()
    text = "Prés salés, Ökosystem № 5 — 草地"
    assert tok.encode(text) == ref.encode(text)
    assert tok.encode("&eacute;t&eacute; meadow") == ref.encode(
        "&eacute;t&eacute; meadow")
    fresh = ClipBPETokenizer()
    monkeypatch.setitem(sys.modules, "regex", None)
    with pytest.raises(ValueError, match="regex"):
        fresh.encode(text)
    assert fresh.encode("a habitat photo of Bog") == ref.encode(
        "a habitat photo of Bog")


def test_decode_roundtrip_and_context_limit():
    ref, tok = _pair()
    text = "a habitat photo of calcareous grassland, short vegetation height"
    assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))
    assert tok.decode(tok.encode("open sea view")).strip() == "open sea view"
    with pytest.raises(RuntimeError, match="too long"):
        tokenize("grass " * 100)
    assert tokenize("grass " * 100, truncate=True)[0, -1] == tok.eot_id


def _public(module):
    return {k: v for k, v in vars(module).items()
            if k.isupper() and not k.startswith("_")}


@pytest.mark.parametrize("pair", [(taxonomy, jax_taxonomy),
                                  (templates, jax_templates)],
                         ids=["taxonomy", "templates"])
def test_host_tables_equal(pair):
    port, ref = pair
    a, b = _public(port), _public(ref)
    assert a.keys() == b.keys() and a
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k
