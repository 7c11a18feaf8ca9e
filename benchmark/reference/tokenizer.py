"""The hash-bucket CLIP tokenizer that stands in for the published BPE
vocabulary, which is not in the repository: each word of the cleaned,
lower-cased prompt maps to one id by a rolling hash into the vocabulary
less its 512 top ids, after the byte ids; rows are BOS, the ids cut to fit,
EOS, zeros. The program's ``SimpleTokenizer`` without files gives the same
ids; this copy is the reference's own."""

from __future__ import annotations

import html
import re

import numpy as np


def _pattern():
    try:
        import regex

        return regex.compile(r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                             r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
    except ImportError:
        return re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                          r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+", re.IGNORECASE)


PAT = _pattern()


def token_ids(texts: list[str], vocab_size: int, max_len: int) -> np.ndarray:
    """(N, max_len) int64 ids of ``texts``."""
    bos, eos = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), max_len), np.int64)
    for r, text in enumerate(texts):
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip()).strip().lower()
        ids = [bos]
        for word in PAT.findall(text):
            h = 0
            for ch in word:
                h = (h * 131 + ord(ch)) % (vocab_size - 512)
            ids.append(h + 256)
        ids = ids[: max_len - 1] + [eos]
        out[r, : len(ids)] = ids
    return out
