"""A frozen copy of the CLIP byte-level BPE (Radford et al. 2021), ASCII
input only: every prompt of ``cs_prompts.json`` is ASCII.

The merge list is ``clip_bpe_merges.zz`` beside this file (zlib-compressed
UTF-8, one merge per line, OpenAI's ``bpe_simple_vocab_16e6`` order).  The
vocabulary is the 256 byte symbols, the same with ``</w>``, the merges, then
``<|startoftext|>`` and ``<|endoftext|>``: 49,408 ids.
"""

from __future__ import annotations

import html
import re
import zlib
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

_WS = " \t\n\r\x0b\x0c"
_PIECES = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|"
                     rf"'ll|'d|[a-zA-Z]+|[0-9]|[^{_WS}a-zA-Z0-9]+",
                     re.IGNORECASE)


def _byte_symbols() -> Dict[int, str]:
    keep = (list(range(33, 127)) + list(range(161, 173))
            + list(range(174, 256)))
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class Bpe:
    def __init__(self):
        text = zlib.decompress(
            (Path(__file__).parent / "clip_bpe_merges.zz").read_bytes())
        merges = [tuple(line.split()) for line in
                  text.decode("utf-8").split("\n")]
        self.symbols = _byte_symbols()
        vocab = list(self.symbols.values())
        vocab += [s + "</w>" for s in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        if len(vocab) != 49408:
            raise ValueError(f"vocabulary of {len(vocab)} ids, not 49408")
        self.ids = {tok: i for i, tok in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(merges)}

    def _merge(self, piece: str) -> List[str]:
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = list(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.rank.get(p, float("inf")))
            if best not in self.rank:
                break
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def encode(self, text: str) -> List[int]:
        if not text.isascii():
            raise ValueError("this copy encodes ASCII text only")
        text = re.sub(f"[{_WS}]+", " ", html.unescape(html.unescape(text)))
        out = []
        for piece in _PIECES.findall(text.strip().lower()):
            sym = "".join(self.symbols[b] for b in piece.encode("utf-8"))
            out += [self.ids[t] for t in self._merge(sym)]
        return out


@lru_cache()
def _bpe() -> Bpe:
    return Bpe()


def tokenize(texts: Sequence[str], context: int) -> np.ndarray:
    """[N, context] int64 ids: start, the text, end; a text too long is cut
    and its last id set to the end token; zeros after."""
    bpe = _bpe()
    sot, eot = bpe.ids["<|startoftext|>"], bpe.ids["<|endoftext|>"]
    out = np.zeros((len(texts), context), np.int64)
    for row, text in enumerate(texts):
        ids = [sot] + bpe.encode(text) + [eot]
        if len(ids) > context:
            ids = ids[:context]
            ids[-1] = eot
        out[row, :len(ids)] = ids
    return out
