"""A HuggingFace snapshot's fast tokenizer, read from its ``tokenizer.json``
without ``tokenizers`` or ``transformers`` (the counterpart of JAX's
``_hf_tokenizer_fn``, ``aihab_clip_tpu/models/zoo.py:135-157``).

``load_hf_tokenizer(snapshot)`` returns ``tokenize_fn(texts,
context_length) -> int32 [N, ctx]``, the ids of ``AutoTokenizer(...)(texts,
padding="max_length", truncation=True, max_length=ctx)``.  It follows the
``tokenizers`` pipeline: the added tokens are cut out of the raw text, the
rest is normalized, pre-tokenized and run through the model, the sequence
is truncated to ``ctx`` less the post-processor's special tokens, which are
then added, and padding fills it to ``ctx``.  ``tokenizer_config.json`` and
``special_tokens_map.json`` give the pad token and the padding and
truncation sides; Gemma's fast class (SigLIP2's) rebuilds the
post-processor from ``add_bos_token`` / ``add_eos_token`` and pads on the
left unless told otherwise, as ``transformers`` does.

Components read: models ``BPE`` (byte fallback, ``fuse_unk``,
``ignore_merges``, merges as ``"a b"`` strings or pairs) and ``WordLevel``;
normalizers ``Replace``, ``Prepend``, ``Lowercase``, ``NFKC`` and
``Sequence``; pre-tokenizers ``Whitespace``, ``WhitespaceSplit``,
``Metaspace``, ``Split`` and ``Sequence``; the ``TemplateProcessing``
post-processor.  Any other raises ``UnsupportedTokenizerError`` naming its
type.  A snapshot with only a SentencePiece ``spiece.model`` (SigLIP v1)
raises too: its reader is ROADMAP A12b.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# transformers' fast classes that rebuild the post-processor, with their
# defaults (GemmaTokenizerFast: SigLIP2's tokenizer)
_CLASS_DEFAULTS = {
    "GemmaTokenizer": dict(padding_side="left", bos_token="<bos>",
                           eos_token="<eos>", unk_token="<unk>",
                           pad_token="<pad>", add_bos_token=True,
                           add_eos_token=False),
}


class UnsupportedTokenizerError(ValueError):
    """A tokenizer component (or file) this reader does not implement."""


def _token(value) -> Optional[str]:
    """A special token as tokenizer_config.json writes it: a string or an
    ``AddedToken`` dict."""
    return value.get("content") if isinstance(value, dict) else value


def _pattern(spec: Dict) -> str:
    if "String" in spec:
        return re.escape(spec["String"])
    return spec["Regex"]


# ---- normalizers -----------------------------------------------------------

def _normalizer(spec: Optional[Dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(s) for s in spec["normalizers"]]

        def run(s: str) -> str:
            for step in steps:
                s = step(s)
            return s
        return run
    if kind == "Replace":
        pat, content = re.compile(_pattern(spec["pattern"])), spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if kind == "Prepend":
        return lambda s: spec["prepend"] + s if s else s
    if kind == "Lowercase":
        return str.lower
    if kind == "NFKC":
        return lambda s: unicodedata.normalize("NFKC", s)
    raise UnsupportedTokenizerError(f"normalizer {kind!r} is not supported")


# ---- pre-tokenizers: (piece, starts the text) -> pieces -------------------

Piece = Tuple[str, bool]


def _split(s: str, pattern: str, behavior: str, invert: bool = False
           ) -> List[Tuple[int, int]]:
    """``NormalizedString::split`` of ``tokenizers``: the (start, end) of
    each non-empty piece."""
    segs, prev = [], 0
    for m in re.finditer(pattern, s):
        if prev != m.start():
            segs.append(((prev, m.start()), False))
        segs.append(((m.start(), m.end()), True))
        prev = m.end()
    if prev != len(s):
        segs.append(((prev, len(s)), False))
    if invert:
        segs = [(o, not hit) for o, hit in segs]
    if behavior == "Removed":
        out = [o for o, hit in segs if not hit]
    elif behavior == "Isolated":
        out = [o for o, _ in segs]
    elif behavior in ("Contiguous", "MergedWithPrevious", "MergedWithNext"):
        nxt = behavior == "MergedWithNext"
        acc, previous = [], False
        for (a, b), hit in (reversed(segs) if nxt else segs):
            merge = (hit == previous if behavior == "Contiguous"
                     else hit and not previous)
            if merge and acc:
                acc[-1] = (a, acc[-1][1]) if nxt else (acc[-1][0], b)
            else:
                acc.append((a, b))
            previous = hit
        out = acc[::-1] if nxt else acc
    else:
        raise UnsupportedTokenizerError(f"split behavior {behavior!r}")
    return [(a, b) for a, b in out if b > a]


def _pre_tokenizer(spec: Optional[Dict]
                   ) -> Callable[[List[Piece]], List[Piece]]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(pieces: List[Piece]) -> List[Piece]:
            for step in steps:
                pieces = step(pieces)
            return pieces
        return run

    def by_spans(fn: Callable[[str, bool], Tuple[str, List[Tuple[int, int]]]]):
        def run(pieces: List[Piece]) -> List[Piece]:
            out = []
            for s, first in pieces:
                s, spans = fn(s, first)
                out += [(s[a:b], first and a == 0) for a, b in spans]
            return out
        return run

    if kind == "Whitespace":
        return by_spans(lambda s, _: (s, [m.span() for m in re.finditer(
            r"\w+|[^\w\s]+", s)]))
    if kind == "WhitespaceSplit":
        return by_spans(lambda s, _: (s, [m.span() for m in re.finditer(
            r"\S+", s)]))
    if kind == "Split":
        pat = _pattern(spec["pattern"])
        return by_spans(lambda s, _: (s, _split(
            s, pat, spec["behavior"], spec.get("invert", False))))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")

        def meta(s: str, first: bool):
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and first)):
                s = rep + s
            if not spec.get("split", True):
                return s, [(0, len(s))] if s else []
            return s, _split(s, re.escape(rep), "MergedWithNext")
        return by_spans(meta)
    raise UnsupportedTokenizerError(f"pre-tokenizer {kind!r} is not "
                                    "supported")


# ---- models: a pre-tokenized piece -> ids ---------------------------------

def _word_level(spec: Dict) -> Callable[[str], List[int]]:
    vocab, unk = spec["vocab"], spec.get("unk_token")

    def run(word: str) -> List[int]:
        if word in vocab:
            return [vocab[word]]
        if unk not in vocab:
            raise ValueError(f"WordLevel: {word!r} is not in the vocabulary "
                             "and there is no unk token")
        return [vocab[unk]]
    return run


def _bpe(spec: Dict) -> Callable[[str], List[int]]:
    for opt in ("continuing_subword_prefix", "end_of_word_suffix"):
        if spec.get(opt):
            raise UnsupportedTokenizerError(f"BPE option {opt!r}")
    if spec.get("dropout"):
        raise UnsupportedTokenizerError("BPE dropout")
    vocab: Dict[str, int] = spec["vocab"]
    unk = spec.get("unk_token")
    unk_id = vocab.get(unk) if unk is not None else None
    if unk is not None and unk_id is None:
        raise ValueError(f"BPE unk token {unk!r} is not in the vocabulary")
    merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
    for rank, m in enumerate(spec.get("merges", [])):
        a, b = m.split(" ", 1) if isinstance(m, str) else m
        if a not in vocab or b not in vocab or a + b not in vocab:
            raise ValueError(f"BPE merge {a!r} {b!r} leaves the vocabulary")
        merges[(vocab[a], vocab[b])] = (rank, vocab[a + b])
    byte_fallback = bool(spec.get("byte_fallback"))
    fuse_unk, ignore_merges = bool(spec.get("fuse_unk")), bool(
        spec.get("ignore_merges"))

    def run(word: str) -> List[int]:
        if ignore_merges and word in vocab:
            return [vocab[word]]
        ids: List[int] = []
        last_unk = False
        for ch in word:
            if ch in vocab:
                ids.append(vocab[ch])
                last_unk = False
                continue
            if byte_fallback:
                codes = [vocab.get(f"<0x{b:02X}>") for b in ch.encode()]
                if None not in codes:
                    ids += codes
                    last_unk = False
                    continue
            if unk_id is None:
                continue
            if not (fuse_unk and last_unk):
                ids.append(unk_id)
            last_unk = True
        # tokenizers' Word::merge_all: a min-heap on (rank, position) over a
        # linked list of symbols; stale entries are skipped when popped
        n = len(ids)
        nxt, prv, alive = list(range(1, n + 1)), list(range(-1, n - 1)), \
            [True] * n
        heap = [(merges[p][0], i, merges[p][1]) for i, p in
                enumerate(zip(ids, ids[1:])) if p in merges]
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            if merges.get((ids[pos], ids[right]), (0, None))[1] != new_id:
                continue
            ids[pos], alive[right] = new_id, False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0 and (ids[prv[pos]], new_id) in merges:
                r, nid = merges[(ids[prv[pos]], new_id)]
                heapq.heappush(heap, (r, prv[pos], nid))
            if nxt[pos] < n and (new_id, ids[nxt[pos]]) in merges:
                r, nid = merges[(new_id, ids[nxt[pos]])]
                heapq.heappush(heap, (r, pos, nid))
        return [t for t, a in zip(ids, alive) if a]
    return run


def _model(spec: Dict) -> Callable[[str], List[int]]:
    kind = spec.get("type") or ("BPE" if "merges" in spec else None)
    if kind == "BPE":
        return _bpe(spec)
    if kind == "WordLevel":
        return _word_level(spec)
    raise UnsupportedTokenizerError(f"model {kind!r} is not supported")


# ---- the pipeline ---------------------------------------------------------

class HFTokenizer:
    """A snapshot's ``tokenizer.json`` with its transformers settings."""

    def __init__(self, snap):
        snap = Path(snap)
        path = snap / "tokenizer.json"
        if not path.is_file():
            if (snap / "spiece.model").is_file():
                raise UnsupportedTokenizerError(
                    f"{snap} holds a SentencePiece spiece.model and no "
                    "tokenizer.json: its reader is ROADMAP A12b")
            raise FileNotFoundError(f"{snap} holds no tokenizer.json")
        spec = json.loads(path.read_text(encoding="utf-8"))
        settings: Dict = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            if (snap / name).is_file():
                settings.update(json.loads((snap / name).read_text(
                    encoding="utf-8")))
        cls = str(settings.get("tokenizer_class")
                  or "PreTrainedTokenizerFast").removesuffix("Fast")
        if cls not in _CLASS_DEFAULTS and cls != "PreTrainedTokenizer":
            raise UnsupportedTokenizerError(
                f"tokenizer_class {settings['tokenizer_class']!r} is not "
                "supported")
        settings = {**_CLASS_DEFAULTS.get(cls, {}), **settings}

        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = _model(spec["model"])
        self.vocab = dict(spec["model"]["vocab"])
        added = spec.get("added_tokens") or []
        for tok in added:
            self.vocab.setdefault(tok["content"], tok["id"])
        self.added = {t["content"]: t for t in added}
        by_len = sorted(self.added, key=len, reverse=True)
        self._raw_re = self._alternation(
            [c for c in by_len if not self.added[c].get("normalized")])
        self._norm_re = self._alternation(
            [c for c in by_len if self.added[c].get("normalized")])

        if cls in _CLASS_DEFAULTS:
            self.template = [
                self._id(_token(settings[t]), t) for t in ("bos_token",)
                if settings.get("add_bos_token")] + [None] + [
                self._id(_token(settings[t]), t) for t in ("eos_token",)
                if settings.get("add_eos_token")]
        else:
            self.template = self._template(spec.get("post_processor"))
        self.pad_id = self._id(_token(settings.get("pad_token")), "pad_token")
        self.padding_left = settings.get("padding_side", "right") == "left"
        self.truncate_left = settings.get("truncation_side",
                                          "right") == "left"

    @staticmethod
    def _alternation(contents: List[str]) -> Optional[re.Pattern]:
        return re.compile("|".join(map(re.escape, contents))) \
            if contents else None

    def _id(self, token: Optional[str], what: str) -> int:
        if token is None or token not in self.vocab:
            raise ValueError(f"{what} {token!r} is not in the vocabulary")
        return self.vocab[token]

    @staticmethod
    def _template(spec: Optional[Dict]) -> List[Optional[int]]:
        """The single-sequence template: special ids around ``None`` (the
        sequence)."""
        if spec is None:
            return [None]
        if spec["type"] != "TemplateProcessing":
            raise UnsupportedTokenizerError(
                f"post-processor {spec['type']!r} is not supported")
        out: List[Optional[int]] = []
        for item in spec["single"]:
            if "Sequence" in item:
                out.append(None)
            else:
                out += spec["special_tokens"][item["SpecialToken"]["id"]][
                    "ids"]
        return out

    def _cut_added(self, s: str, pat: Optional[re.Pattern]
                   ) -> List[Tuple[str, Optional[int], int]]:
        """``AddedVocabulary::split_with_indices``: (text, added id or None,
        start offset) pieces."""
        if pat is None:
            return [(s, None, 0)] if s else []
        out, start = [], 0
        for m in pat.finditer(s):
            a, b = m.span()
            tok = self.added[m.group()]
            if tok.get("single_word") and (
                    (a > 0 and (s[a - 1].isalnum() or s[a - 1] == "_"))
                    or (b < len(s) and (s[b].isalnum() or s[b] == "_"))):
                continue
            if tok.get("lstrip"):
                while a > start and s[a - 1].isspace():
                    a -= 1
            if tok.get("rstrip"):
                while b < len(s) and s[b].isspace():
                    b += 1
            if a > start:
                out.append((s[start:a], None, start))
            out.append((s[a:b], tok["id"], a))
            start = b
        if start < len(s):
            out.append((s[start:], None, start))
        return out

    def encode(self, text: str) -> List[int]:
        """The ids of one text before truncation, without the
        post-processor's special tokens."""
        ids: List[int] = []
        for raw, tid, at in self._cut_added(text, self._raw_re):
            if tid is not None:
                ids.append(tid)
                continue
            for s, nid, off in self._cut_added(self.normalize(raw),
                                               self._norm_re):
                if nid is not None:
                    ids.append(nid)
                    continue
                for word, _ in self.pre_tokenize([(s, at == 0 and off == 0)]):
                    ids += self.model(word)
        return ids

    def __call__(self, texts, context_length: int) -> np.ndarray:
        n_special = sum(t is not None for t in self.template)
        keep = context_length - n_special
        if keep < 0:
            raise ValueError(f"context {context_length} is shorter than the "
                             f"{n_special} special tokens")
        out = np.full((len(texts), context_length), self.pad_id, np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > keep:
                ids = ids[len(ids) - keep:] if self.truncate_left \
                    else ids[:keep]
            seq: List[int] = []
            for t in self.template:
                seq += ids if t is None else [t]
            if self.padding_left:
                out[row, context_length - len(seq):] = seq
            else:
                out[row, :len(seq)] = seq
        return out


def load_hf_tokenizer(snap) -> HFTokenizer:
    """The snapshot directory's tokenizer: callable as
    ``tokenize_fn(texts, context_length) -> int32 [N, ctx]``."""
    return HFTokenizer(snap)
