"""CLIP byte-pair-encoding tokenizer.

A from-scratch implementation of the public CLIP BPE scheme (lower-cased
byte-level BPE, 49,152-token vocab, ``<|startoftext|>``/``<|endoftext|>``
specials, 77-token context) with the exact ``tokenize``/truncate semantics the
reference relies on (``clip.tokenize(..., truncate=True)`` at reference
``src/clip/train/trainer.py:164-165`` and ``max_length=77`` at
``src/clip/eval/evaluator_hf.py:121-127``).

Vocabulary files are loaded at runtime — either the OpenAI
``bpe_simple_vocab_16e6.txt.gz`` format or HuggingFace ``vocab.json`` +
``merges.txt`` — so no third-party tokenizer package is needed. The encoder is
on the host (the C++ merge engine of the port's
``native.bpe_wrapper`` when it builds, pure Python otherwise); output is a
dense int32 ``[N, context_length]`` array ready for device transfer.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/data/tokenizer.py``:
the port imports nothing of that package, so it carries this numpy copy. A
batch call counts its words, and :meth:`CLIPTokenizer.bpe` each word the
merge cache did not hold, in the counters of ``utils.profiling``.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.profiling import count

try:  # \p{L}/\p{N} classes need the third-party `regex` module
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

# ftfy mojibake repair, looked up once: where ftfy is absent, an import
# attempted per query costs ~0.5 ms of import-path scanning (141 ms per
# 256-query batch, measured on the host CPU of an H100 server)
try:  # pragma: no cover - ftfy not in the baked image
    import ftfy as _ftfy
except ImportError:
    _ftfy = None

# The CLIP word-split pattern: specials, common English contractions, letter
# runs, single digits, punctuation runs (case-insensitive).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char map (standard GPT-2/CLIP scheme).

    Printable bytes map to themselves; the rest are shifted into the private
    range starting at U+0100 so every byte has a visible, whitespace-free
    representative.
    """
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    """HTML-unescape twice and strip (ftfy mojibake repair applied if available)."""
    if _ftfy is not None:  # pragma: no cover - ftfy not in the baked image
        text = _ftfy.fix_text(text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


class CLIPTokenizer:
    """Byte-level BPE tokenizer with CLIP semantics.

    Parameters
    ----------
    merges: ordered list of merge pairs ``(a, b)``.
    vocab: optional explicit token->id map. If omitted, the vocabulary is
        built in the canonical CLIP order: 256 byte chars, the same 256 with a
        ``</w>`` suffix, one merged token per merge rule, then the two
        specials.
    """

    def __init__(
        self,
        merges: Sequence[Tuple[str, str]],
        vocab: Optional[Dict[str, int]] = None,
        use_native: Optional[bool] = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {tuple(m): i for i, m in enumerate(merges)}
        # optional C++ merge engine (host hot path); None -> pure Python
        self._native = None
        if use_native or use_native is None:
            try:
                from ..native.bpe_wrapper import NativeBPE

                self._native = NativeBPE.create(merges)
            except Exception:
                self._native = None
            if use_native and self._native is None:
                raise RuntimeError("native BPE requested but unavailable (no g++?)")
        if vocab is None:
            chars = list(self.byte_encoder.values())
            tokens = chars + [c + "</w>" for c in chars]
            tokens += ["".join(m) for m in merges]
            tokens += [SOT, EOT]
            vocab = {t: i for i, t in enumerate(tokens)}
        self.encoder: Dict[str, int] = dict(vocab)
        self.decoder: Dict[int, str] = {v: k for k, v in self.encoder.items()}
        self.sot_token = self.encoder[SOT]
        self.eot_token = self.encoder[EOT]
        self._cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_openai_vocab(cls, path: str) -> "CLIPTokenizer":
        """Load the OpenAI ``bpe_simple_vocab_16e6.txt.gz`` merges file."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:  # type: ignore[operator]
            lines = f.read().split("\n")
        # line 0 is a version header; CLIP uses merges [1 : 49152-256-2+1]
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(l.split()) for l in merge_lines if l.strip()]
        return cls(merges)  # canonical vocab order

    @classmethod
    def from_hf_files(cls, vocab_json: str, merges_txt: str) -> "CLIPTokenizer":
        """Load HuggingFace ``vocab.json`` + ``merges.txt`` (same scheme)."""
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if l.strip()]
        return cls(merges, vocab=vocab)

    @classmethod
    def find_default(cls) -> "CLIPTokenizer":
        """Locate a vocab file from env ``CLIP_BPE_PATH`` or common locations."""
        candidates = [os.environ.get("CLIP_BPE_PATH")]
        candidates += [
            os.path.join(os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz"),
            os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
        ]
        for c in candidates:
            if c and os.path.exists(c):
                return cls.from_openai_vocab(c)
        raise FileNotFoundError(
            "No CLIP BPE vocab found. Set CLIP_BPE_PATH to bpe_simple_vocab_16e6.txt.gz "
            "or place it under knowledge_enhanced_multimodal_retrieval_tpu_torch/data/assets/."
        )

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- core BPE -----------------------------------------------------------

    def bpe(self, token: str) -> str:
        """Apply merge rules to one pre-tokenized word (byte-encoded chars);
        each word computed here, not found in the cache, counts as a
        ``tokenizer.bpe_misses``."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        count("tokenizer.bpe_misses")
        if self._native is not None:
            result = self._native.apply(token)
            self._cache[token] = result
            return result
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        return self._encode_words(self._words(text))

    def _words(self, text: str) -> List[str]:
        return _PAT.findall(whitespace_clean(basic_clean(text)).lower())

    def _encode_words(self, words: List[str]) -> List[int]:
        ids: List[int] = []
        for tok in words:
            tok_bytes = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok_bytes).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    # -- batch tokenize (clip.tokenize semantics) ---------------------------

    def __call__(
        self,
        texts,
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = True,
    ) -> np.ndarray:
        """Tokenize to a zero-padded int32 ``[N, context_length]`` array.

        Matches ``clip.tokenize``: ``[SOT] + bpe(text) + [EOT]``, zero padded;
        with ``truncate`` the sequence is cut to ``context_length`` and the
        final position forced to EOT, otherwise overlong input raises.
        Counts the call's words (``tokenizer.words``; :meth:`bpe` counts
        the misses).
        """
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        n_words = 0
        for row, text in enumerate(texts):
            words = self._words(text)
            n_words += len(words)
            toks = [self.sot_token] + self._encode_words(words) + [self.eot_token]
            if len(toks) > context_length:
                if not truncate:
                    raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
                toks = toks[:context_length]
                toks[-1] = self.eot_token
            out[row, : len(toks)] = toks
        count("tokenizer.words", n_words)
        return out


# 16 serves genuinely short queries (<= 14 BPE tokens + SOT/EOT) at half
# the encode cost of 32; sublane-aligned (16) so every kernel tiles it
DEFAULT_BUCKETS = (16, 32, 64, CONTEXT_LENGTH)


def trim_to_bucket(ids: np.ndarray, buckets: Sequence[int] = DEFAULT_BUCKETS) -> np.ndarray:
    """Trim trailing padding columns to the smallest bucket that fits.

    Exact-math optimization for the causal text tower: positions after EOT
    never influence positions up to EOT (causal mask) and pooling reads the
    EOT position, so dropping all-zero trailing columns changes nothing but
    the compute. One jit compilation per bucket instead of per length.
    """
    if ids.size == 0:
        return ids
    # last nonzero column per row = the EOT position (EOT id is never 0;
    # id 0 is a real token ('!') that may appear mid-sequence, so count from
    # the end rather than summing nonzeros)
    nonzero_rev = (np.asarray(ids) != 0)[:, ::-1]
    last_nonzero = ids.shape[1] - 1 - np.argmax(nonzero_rev, axis=1)
    used = int(np.max(last_nonzero)) + 1
    for b in sorted(buckets):
        if used <= b <= ids.shape[1]:
            return ids[:, :b]
    return ids


def truncate_words(text: str, max_words: int = 150) -> str:
    """Word-level pre-truncation (reference ``clip_dataset.py:49-54``)."""
    words = text.split()
    if len(words) <= max_words:
        return text
    return " ".join(words[:max_words])
