from .bpe import (
    CONTEXT_LENGTH,
    VOCAB_SIZE,
    ClipBPETokenizer,
    get_tokenizer,
    tokenize,
)

__all__ = [
    "CONTEXT_LENGTH",
    "VOCAB_SIZE",
    "ClipBPETokenizer",
    "get_tokenizer",
    "tokenize",
]
