"""The port's reader of a HF snapshot's ``tokenizer.json``
(``aihab_clip_tpu_torch/tokenizer/hf_json.py``) against ``AutoTokenizer``
and the JAX package's ``_hf_tokenizer_fn``: synthetic tokenizers built with
``tokenizers`` for each component the reader supports, on every CS prompt
of ``gen_prompts`` (and a few texts with non-ASCII characters, runs of
spaces, an empty one and a special token), at context 64 and at 8, which
truncates.  Unsupported components raise, naming their type."""

import json

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from tokenizers import (Tokenizer, models, normalizers,  # noqa: E402
                        pre_tokenizers, processors, trainers)

from aihab_clip_tpu.models import zoo as jax_zoo  # noqa: E402
from aihab_clip_tpu_torch.templates import gen_prompts  # noqa: E402
from aihab_clip_tpu_torch.tokenizer.hf_json import (  # noqa: E402
    UnsupportedTokenizerError, load_hf_tokenizer)

PROMPTS = [p for h in (True, False) for d in (True, False)
           for p in gen_prompts(use_hierarchy=h, use_descriptive=d)[0]]
TEXTS = PROMPTS + ["café — naïve 🌿 heath", "  double  spaces  ", "",
                   "a <bos>inside", "Grass\tland\nbog", "ÅÖ€ ÅNGSTRÖM ﬁne"]
CONTEXTS = (64, 8)
SPECIALS = ["<pad>", "<eos>", "<bos>", "<unk>"]


def _train_bpe(corpus, byte_fallback=True, **kw):
    """A BPE trained on a few prompts; with byte_fallback the 256 <0xNN>
    tokens join its vocabulary."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", **kw))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=300, special_tokens=SPECIALS, show_progress=False))
    spec = json.loads(tok.to_str())
    spec["pre_tokenizer"] = None
    spec["model"]["byte_fallback"] = byte_fallback
    if byte_fallback:
        vocab = spec["model"]["vocab"]
        for b in range(256):
            vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    return Tokenizer.from_str(json.dumps(spec))


def _words_vocab():
    words = sorted({w for p in PROMPTS for w in p.lower().replace(
        ",", " , ").replace(".", " . ").split()})
    vocab = {t: i for i, t in enumerate(SPECIALS)}
    vocab.update({w: i + len(SPECIALS) for i, w in enumerate(words)})
    return vocab


def _snapshot(path, tok, cls="PreTrainedTokenizerFast", string_merges=False,
              **kwargs):
    """Save ``tok`` as transformers' fast class ``cls`` would into a
    snapshot directory; ``string_merges`` rewrites the merges in the older
    ``"a b"`` form."""
    kwargs.setdefault("pad_token", "<pad>")
    fast = getattr(transformers, cls)(tokenizer_object=tok, **kwargs)
    fast.save_pretrained(str(path))
    if string_merges:
        spec = json.loads((path / "tokenizer.json").read_text())
        spec["model"]["merges"] = [" ".join(m) if isinstance(m, list) else m
                                   for m in spec["model"]["merges"]]
        (path / "tokenizer.json").write_text(json.dumps(spec))
    return path


def _assert_ids_equal(snap):
    ref = transformers.AutoTokenizer.from_pretrained(str(snap))
    mine = load_hf_tokenizer(snap)
    for ctx in CONTEXTS:
        want = ref(TEXTS, padding="max_length", truncation=True,
                   max_length=ctx, return_tensors="np")["input_ids"]
        got = mine(TEXTS, ctx)
        assert got.dtype == np.int32 and got.shape == (len(TEXTS), ctx)
        bad = [TEXTS[i] for i in np.nonzero((got != want).any(1))[0]]
        assert not bad, (ctx, bad[:3])


def _gemma(tmp_path, **kw):
    tok = _train_bpe([p.replace(" ", "▁") for p in PROMPTS[:10]],
                     fuse_unk=True)
    tok.normalizer = normalizers.Replace(" ", "▁")
    return _snapshot(tmp_path, tok, cls="GemmaTokenizerFast", **kw)


@pytest.mark.parametrize("string_merges", [False, True])
@pytest.mark.parametrize("add_eos", [False, True])
def test_gemma_byte_fallback_bpe(tmp_path, string_merges, add_eos):
    """SigLIP2's layout: a Gemma fast tokenizer (left padding, <bos>, and
    <eos> where its config asks), a byte-fallback BPE over a Replace
    normalizer, no pre-tokenizer; merges as pairs or "a b" strings."""
    snap = _gemma(tmp_path, string_merges=string_merges,
                  add_eos_token=add_eos)
    spec = json.loads((snap / "tokenizer.json").read_text())
    assert isinstance(spec["model"]["merges"][0], str) == string_merges
    _assert_ids_equal(snap)
    ids = load_hf_tokenizer(snap)(["naïve 🌿"], 16)[0]
    vocab = spec["model"]["vocab"]
    assert vocab["<0xF0>"] in ids        # the leaf's UTF-8 bytes


@pytest.mark.parametrize("prepend", ["always", "first", "never"])
@pytest.mark.parametrize("split", [True, False])
def test_metaspace_lowercase_nfkc(tmp_path, prepend, split):
    """A SentencePiece-style BPE: NFKC + Lowercase, Metaspace in each
    prepend scheme, split or whole, a <s> $A </s> template."""
    tok = _train_bpe(["▁" + p.lower().replace(" ", "▁") for p in PROMPTS[:8]],
                     fuse_unk=False)
    tok.normalizer = normalizers.Sequence([normalizers.NFKC(),
                                           normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(prepend_scheme=prepend,
                                                 split=split)
    tok.post_processor = processors.TemplateProcessing(
        single="<bos> $A <eos>", special_tokens=[
            ("<bos>", tok.token_to_id("<bos>")),
            ("<eos>", tok.token_to_id("<eos>"))])
    _assert_ids_equal(_snapshot(tmp_path, tok, bos_token="<bos>",
                                eos_token="<eos>", unk_token="<unk>"))


@pytest.mark.parametrize("fuse_unk", [False, True])
def test_prepend_replace_left_truncation(tmp_path, fuse_unk):
    """Sequence[Prepend, Replace] normalizers, no byte fallback (unknown
    characters are <unk>, fused or not), truncation and padding from the
    left."""
    tok = _train_bpe(["▁" + p.replace(" ", "▁") for p in PROMPTS[:6]],
                     byte_fallback=False, fuse_unk=fuse_unk)
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.post_processor = processors.TemplateProcessing(
        single="$A <eos>", special_tokens=[("<eos>", tok.token_to_id(
            "<eos>"))])
    snap = _snapshot(tmp_path, tok, eos_token="<eos>", unk_token="<unk>",
                     truncation_side="left", padding_side="left")
    _assert_ids_equal(snap)


@pytest.mark.parametrize("behavior", ["removed", "isolated",
                                      "merged_with_previous",
                                      "merged_with_next", "contiguous"])
@pytest.mark.parametrize("invert", [False, True])
def test_split_pre_tokenizer(tmp_path, behavior, invert):
    """Split (a regex, each delimiter behavior, inverted or not) in a
    Sequence after WhitespaceSplit, over a WordLevel vocabulary."""
    tok = Tokenizer(models.WordLevel(_words_vocab(), unk_token="<unk>"))
    tok.normalizer = normalizers.Lowercase()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(),
        pre_tokenizers.Split(tokenizers.Regex(r"[,.\-]+|ed\b"), behavior,
                             invert=invert)])
    _assert_ids_equal(_snapshot(tmp_path, tok, unk_token="<unk>"))


def test_whitespace_wordlevel_as_jax_tests(tmp_path, monkeypatch):
    """JAX's own test tokenizer (tests/test_siglip.py:170-180): WordLevel
    over Whitespace, in an HF hub layout; the port's ids equal JAX's
    tokenize_fn and AutoTokenizer's."""
    tok = Tokenizer(models.WordLevel(_words_vocab(), unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    repo = "google/siglip2-tokenizer-test"
    snap = (tmp_path / "hub" / f"models--{repo.replace('/', '--')}"
            / "snapshots" / "deadbeef")
    snap.mkdir(parents=True)
    _snapshot(snap, tok, unk_token="<unk>", eos_token="<eos>")
    (snap / "model.safetensors").write_bytes(b"")   # a snapshot with weights
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    _assert_ids_equal(snap)
    jax_fn = jax_zoo._hf_tokenizer_fn(repo)
    for ctx in CONTEXTS:
        np.testing.assert_array_equal(load_hf_tokenizer(snap)(TEXTS, ctx),
                                      jax_fn(TEXTS, ctx))


def test_added_tokens_and_ignore_merges(tmp_path):
    """Added tokens are cut out before normalization (a special one in the
    raw text, a normalized one after Lowercase, lstrip/rstrip ones), and
    ignore_merges takes a whole word that is in the vocabulary."""
    tok = _train_bpe([p.replace(" ", "▁") for p in PROMPTS[:10]],
                     fuse_unk=True, ignore_merges=True)
    spec = json.loads(tok.to_str())
    spec["model"]["vocab"]["▁habitat▁photo"] = len(spec["model"]["vocab"])
    tok = Tokenizer.from_str(json.dumps(spec))
    tok.normalizer = normalizers.Sequence([normalizers.Lowercase(),
                                           normalizers.Replace(" ", "▁")])
    tok.add_tokens([tokenizers.AddedToken("grass", normalized=True),
                    tokenizers.AddedToken("[SEP]", lstrip=True, rstrip=True,
                                          normalized=False),
                    tokenizers.AddedToken("bog", single_word=True,
                                          normalized=False)])
    snap = _snapshot(tmp_path, tok, bos_token="<bos>", unk_token="<unk>")
    extra = ["GRASS and Grassland [SEP]  heath", "bog bogland <bos>"]
    ref = transformers.AutoTokenizer.from_pretrained(str(snap))
    want = ref(TEXTS + extra, padding="max_length", truncation=True,
               max_length=64, return_tensors="np")["input_ids"]
    np.testing.assert_array_equal(load_hf_tokenizer(snap)(TEXTS + extra, 64),
                                  want)


@pytest.mark.parametrize("part,spec,kind", [
    ("model", {"type": "Unigram", "vocab": [["<unk>", 0.0]]}, "Unigram"),
    ("normalizer", {"type": "NFD"}, "NFD"),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False,
                       "trim_offsets": True, "use_regex": True},
     "ByteLevel"),
    ("post_processor", {"type": "BertProcessing", "sep": ["<eos>", 1],
                        "cls": ["<bos>", 2]}, "BertProcessing"),
])
def test_unsupported_component_raises(tmp_path, part, spec, kind):
    snap = _gemma(tmp_path)
    tj = json.loads((snap / "tokenizer.json").read_text())
    tj[part] = spec
    (snap / "tokenizer.json").write_text(json.dumps(tj))
    cfg = json.loads((snap / "tokenizer_config.json").read_text())
    cfg["tokenizer_class"] = "PreTrainedTokenizerFast"
    (snap / "tokenizer_config.json").write_text(json.dumps(cfg))
    with pytest.raises(UnsupportedTokenizerError, match=kind):
        load_hf_tokenizer(snap)


def test_sentencepiece_only_snapshot_names_a12b(tmp_path):
    (tmp_path / "spiece.model").write_bytes(b"\x00")
    with pytest.raises(UnsupportedTokenizerError, match="A12b"):
        load_hf_tokenizer(tmp_path)
    (tmp_path / "spiece.model").unlink()
    with pytest.raises(FileNotFoundError):
        load_hf_tokenizer(tmp_path)
