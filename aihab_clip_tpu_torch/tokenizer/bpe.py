"""Byte-level BPE tokenizer with the exact CLIP vocabulary (49 408 tokens).

The pure-Python path of ``aihab_clip_tpu/tokenizer/bpe.py`` (byte<->unicode
table, lowest-rank greedy merges, ``</w>`` end-of-word marker, SOT/EOT
specials) over its own copy of the merge list
(``assets/clip_bpe_merges.zz``: zlib-compressed UTF-8, one merge per line).

The CLIP pre-tokeniser pattern needs the ``regex`` module's ``\\p{L}`` /
``\\p{N}`` classes.  On ASCII text those are ``[a-zA-Z]`` and ``[0-9]``, so
ASCII input — every prompt this project builds — runs on stdlib ``re`` with
a pattern that yields the same pieces; other input uses ``regex`` when it is
importable and raises otherwise.  Whitespace is spelled out as the ASCII
set ``regex``'s ``\\s`` matches: stdlib ``\\s`` also matches ``\\x1c-\\x1f``.
There is no ``ftfy`` step and no native fast path.
"""

from __future__ import annotations

import html
import os
import re
import zlib
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408

_SPECIALS = r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
_WS = " \t\n\r\x0b\x0c"
_ASCII_PAT = re.compile(
    _SPECIALS + rf"|[a-zA-Z]+|[0-9]|[^{_WS}a-zA-Z0-9]+", re.IGNORECASE)
_ASCII_WS = re.compile(f"[{_WS}]+")


@lru_cache()
def default_merges_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "assets", "clip_bpe_merges.zz")


@lru_cache()
def byte_to_unicode() -> Dict[int, str]:
    """Reversible map from utf-8 bytes to printable unicode chars."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    mapping: Dict[int, str] = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _load_merges(path: str) -> List[Tuple[str, str]]:
    with open(path, "rb") as f:
        text = zlib.decompress(f.read()).decode("utf-8")
    return [tuple(line.split()) for line in text.split("\n")]


def _unicode_regex():
    try:
        import regex
    except ImportError as e:
        raise ValueError(
            "non-ASCII text needs the 'regex' module for CLIP's unicode "
            "pre-tokeniser; it is not installed") from e
    return regex


def clean_text(text: str) -> str:
    """html unescape (twice) + whitespace fold + strip."""
    text = html.unescape(html.unescape(text))
    if text.isascii():
        text = _ASCII_WS.sub(" ", text)
    else:
        text = _unicode_regex().sub(r"\s+", " ", text)
    return text.strip()


class ClipBPETokenizer:
    """Exact CLIP byte-level BPE."""

    def __init__(self, merges_path: str | None = None):
        self.byte_encoder = byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = _load_merges(merges_path or default_merges_path())

        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        if len(vocab) != VOCAB_SIZE:
            raise ValueError(f"vocab size {len(vocab)} != {VOCAB_SIZE}")

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.merge_ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self._cache: Dict[str, str] = {SOT_TOKEN: SOT_TOKEN,
                                       EOT_TOKEN: EOT_TOKEN}
        self._unicode_pat = None

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TOKEN]

    def _bpe(self, token: str) -> str:
        """Apply merges greedily (lowest rank first) to one pre-token."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            ranks = [self.merge_ranks.get(pair) for pair in zip(word, word[1:])]
            best = min((r for r in ranks if r is not None), default=None)
            if best is None:
                break
            first, second = word[ranks.index(best)], word[ranks.index(best) + 1]
            merged: List[str] = []
            i = 0
            while i < len(word):  # merge every occurrence in one sweep
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _pieces(self, text: str) -> List[str]:
        if text.isascii():
            return _ASCII_PAT.findall(text)
        if self._unicode_pat is None:
            self._unicode_pat = _unicode_regex().compile(
                _SPECIALS + r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
                _unicode_regex().IGNORECASE)
        return self._unicode_pat.findall(text)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self._pieces(clean_text(text).lower()):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@lru_cache()
def get_tokenizer() -> ClipBPETokenizer:
    return ClipBPETokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize into a fixed [N, context_length] int32 array with SOT/EOT;
    raises when a prompt exceeds the context length unless ``truncate``
    (which keeps EOT as the last id)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.sot_id, tok.eot_id
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [sot] + tok.encode(text) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context "
                                   f"length {context_length}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[row, :len(ids)] = ids
    return out
