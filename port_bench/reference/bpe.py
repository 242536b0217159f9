"""CLIP's byte-level BPE tokenizer, written plainly from the published
scheme (OpenAI ``clip/simple_tokenizer.py``): lower-cased text, the CLIP
word pattern, bytes mapped to printable characters, merges applied by rank
inside each word, ``<|startoftext|>`` ... ``<|endoftext|>`` and zero
padding to 77 with the last position forced to EOT on truncation. Ids run
256 bytes, 256 bytes with ``</w>``, one per merge, then the two specials.

Also the serving rule that trims a batch's columns to the smallest length
bucket that holds its longest row.
"""

from __future__ import annotations

import html
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:
    import regex as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )
except ImportError:  # the standard library's classes agree on ASCII text
    import re as _re

    _PAT = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+|_+""",
        _re.IGNORECASE,
    )

SOT, EOT = "<|startoftext|>", "<|endoftext|>"


def _byte_chars() -> List[str]:
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    chars = {}
    extra = 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    order = keep + [b for b in range(256) if b not in keep]
    return [chars[b] for b in order], chars


def bpe_word(word: str, rank: Dict[Tuple[str, str], int]) -> List[str]:
    """One word's characters (the last with ``</w>``) merged pair by pair,
    the best-ranked adjacent pair first, every occurrence of it at once."""
    parts = list(word[:-1]) + [word[-1] + "</w>"]
    while len(parts) > 1:
        pairs = [p for p in zip(parts, parts[1:]) if p in rank]
        if not pairs:
            break
        a, b = min(pairs, key=rank.__getitem__)
        merged, i = [], 0
        while i < len(parts):
            if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                merged.append(a + b)
                i += 2
            else:
                merged.append(parts[i])
                i += 1
        parts = merged
    return parts


class Tokenizer:
    def __init__(self, merges: Sequence[Tuple[str, str]]):
        order, self.byte_char = _byte_chars()
        vocab = order + [c + "</w>" for c in order] + ["".join(m) for m in merges] + [SOT, EOT]
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        if len(self.ids) != len(vocab):
            raise ValueError("merge table makes duplicate tokens")
        self.rank = {tuple(m): i for i, m in enumerate(merges)}
        self.sot, self.eot = self.ids[SOT], self.ids[EOT]
        self.words: Dict[str, List[str]] = {}

    def bpe(self, word: str) -> List[str]:
        if word in self.words:
            return self.words[word]
        parts = bpe_word(word, self.rank)
        self.words[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text)).strip()
        text = " ".join(text.split()).lower()
        out: List[int] = []
        for piece in _PAT.findall(text):
            word = "".join(self.byte_char[b] for b in piece.encode("utf-8"))
            out += [self.ids[t] for t in self.bpe(word)]
        return out

    def __call__(self, texts: Sequence[str], context: int = 77) -> np.ndarray:
        out = np.zeros((len(texts), context), np.int64)
        for r, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context:
                toks = toks[:context]
                toks[-1] = self.eot
            out[r, : len(toks)] = toks
        return out

    def count(self, text: str) -> int:
        """Tokens of ``text`` with SOT and EOT, before truncation."""
        return len(self.encode(text)) + 2


def truncate_words(text: str, max_words: int = 150) -> str:
    words = text.split()
    return text if len(words) <= max_words else " ".join(words[:max_words])


def trim_to_bucket(ids: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """The columns up to the smallest bucket that holds every row's last
    non-zero id (the EOT)."""
    nz = np.nonzero(np.any(ids != 0, axis=0))[0]
    used = int(nz[-1]) + 1 if nz.size else 0
    for b in sorted(buckets):
        if used <= b <= ids.shape[1]:
            return ids[:, :b]
    return ids
