"""Inputs made from ``--seed``: weights, corpus rows, the merge table, query
strings and training records.

Everything the program and the reference are handed comes from here, so
both sides get the same inputs and the same seed gives the same inputs.
Large tensors are drawn on the device with a ``torch.Generator`` in a few
large calls; host-side text comes from ``random.Random`` seeded from the
same seed. A sub-stream is named (``"weights"``, ``"corpus.image"``...), so
that adding a stream never shifts another.
"""

from __future__ import annotations

import hashlib
import math
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from .reference.bpe import bpe_word

CONTEXT = 77
N_MERGES = 48_894  # CLIP's merge count: 256 + 256 + 48,894 + 2 specials = 49,408 ids


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for the named stream of ``seed``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(names)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, name))


# ---------------------------------------------------------------------------
# CLIP weights
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Arch:
    """The sizes of one CLIP, read from a configuration file."""

    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_heads: int
    vision_patch_size: int
    context_length: int
    vocab_size: int
    text_width: int
    text_heads: int
    text_layers: int

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size

    @classmethod
    def from_config(cls, cfg: dict) -> "Arch":
        t, v = cfg["text_config"], cfg["vision_config"]
        return cls(
            embed_dim=cfg["projection_dim"], image_resolution=v["image_size"], vision_layers=v["num_hidden_layers"],
            vision_width=v["hidden_size"], vision_heads=v["num_attention_heads"], vision_patch_size=v["patch_size"],
            context_length=t["max_position_embeddings"], vocab_size=t["vocab_size"], text_width=t["hidden_size"],
            text_heads=t["num_attention_heads"], text_layers=t["num_hidden_layers"],
        )


def _block_leaves(prefix: str, w: int) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of one residual block; std 0 = zeros, -1 = ones."""
    return [
        (f"{prefix}.ln_1.weight", (w,), -1), (f"{prefix}.ln_1.bias", (w,), 0),
        (f"{prefix}.attn.in_proj_weight", (3 * w, w), w ** -0.5), (f"{prefix}.attn.in_proj_bias", (3 * w,), 0),
        (f"{prefix}.attn.out_proj.weight", (w, w), w ** -0.5), (f"{prefix}.attn.out_proj.bias", (w,), 0),
        (f"{prefix}.ln_2.weight", (w,), -1), (f"{prefix}.ln_2.bias", (w,), 0),
        (f"{prefix}.mlp.c_fc.weight", (4 * w, w), w ** -0.5), (f"{prefix}.mlp.c_fc.bias", (4 * w,), 0),
        (f"{prefix}.mlp.c_proj.weight", (w, 4 * w), (4 * w) ** -0.5), (f"{prefix}.mlp.c_proj.bias", (w,), 0),
    ]


def clip_leaves(a: Arch) -> List[Tuple[str, tuple, float]]:
    """Every parameter of a CLIP in OpenAI's layout (the text tower's under
    ``text.``), with the init scale of the published recipe: lecun-normal
    projections and patch conv, zero biases, unit LayerNorms, 0.01 text
    positions, width^-0.5 class token, vision positions and projections."""
    wv, wt, p = a.vision_width, a.text_width, a.vision_patch_size
    leaves = [
        ("visual.class_embedding", (wv,), wv ** -0.5),
        ("visual.positional_embedding", (a.grid_size ** 2 + 1, wv), wv ** -0.5),
        ("visual.proj", (wv, a.embed_dim), wv ** -0.5),
        ("visual.conv1.weight", (wv, 3, p, p), (3 * p * p) ** -0.5),
        ("visual.ln_pre.weight", (wv,), -1), ("visual.ln_pre.bias", (wv,), 0),
        ("visual.ln_post.weight", (wv,), -1), ("visual.ln_post.bias", (wv,), 0),
    ]
    for i in range(a.vision_layers):
        leaves += _block_leaves(f"visual.transformer.resblocks.{i}", wv)
    leaves += [
        ("text.token_embedding.weight", (a.vocab_size, wt), wt ** -0.5),
        ("text.positional_embedding", (a.context_length, wt), 0.01),
        ("text.text_projection", (wt, a.embed_dim), wt ** -0.5),
        ("text.ln_final.weight", (wt,), -1), ("text.ln_final.bias", (wt,), 0),
    ]
    for i in range(a.text_layers):
        leaves += _block_leaves(f"text.transformer.resblocks.{i}", wt)
    return leaves


def clip_weights(a: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights on ``device``: one normal draw for every random
    leaf, sliced and scaled; ``logit_scale`` is log(1 / 0.07)."""
    leaves = clip_leaves(a)
    total = sum(math.prod(s) for _, s, std in leaves if std > 0)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {"logit_scale": torch.full((), math.log(1 / 0.07), device=device)}
    at = 0
    for name, shape, std in leaves:
        if std > 0:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        else:
            out[name] = (torch.ones if std < 0 else torch.zeros)(shape, device=device)
    return out


# ---------------------------------------------------------------------------
# Corpus rows
# ---------------------------------------------------------------------------


def corpus_chunks(seed: int, tower: str, rows: int, dim: int, device, chunk: int = 1 << 16) -> Iterator[torch.Tensor]:
    """L2-normalized Gaussian rows ``[<= chunk, dim]`` f32 on ``device``, in
    row order; the same seed gives the same rows whatever reads them."""
    g = generator(seed, "corpus." + tower, device)
    for start in range(0, rows, chunk):
        x = torch.randn(min(chunk, rows - start), dim, generator=g, device=device)
        yield x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def corpus_host(seed: int, tower: str, rows: int, dim: int, device) -> np.ndarray:
    """All rows of one tower as a host f32 array (drawn on ``device``)."""
    out = np.empty((rows, dim), np.float32)
    at = 0
    for x in corpus_chunks(seed, tower, rows, dim, device):
        out[at:at + x.shape[0]] = x.cpu().numpy()
        at += x.shape[0]
    return out


def uuid_prefix(seed: int) -> str:
    return "obj-%08x-" % (sub_seed(seed, "uuids") & 0xFFFFFFFF)


def uuids(seed: int, rows: int) -> List[str]:
    p = uuid_prefix(seed)
    return [f"{p}{i:07d}" for i in range(rows)]


# ---------------------------------------------------------------------------
# Words and the merge table
# ---------------------------------------------------------------------------

_ONSETS = ["b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r", "s", "t", "v", "w", "z",
           "br", "ch", "cr", "dr", "fl", "gr", "pl", "pr", "sh", "st", "th", "tr"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ea", "io", "ou", "y"]
_CODAS = ["", "", "", "n", "r", "s", "l", "m", "t", "nd", "rk", "st"]


def word_list(merge_seed: int, n_rare: int) -> Tuple[List[str], List[str], List[Tuple[str, str]]]:
    """``(words, rare, merges)``: seeded pseudo-words of 1-4 syllables, and a
    merge table learned from ``words`` in order: each word is split by the
    merges so far and its pieces are joined left to right by new merges,
    so every word of the table is one token and an earlier word's merges
    rank higher. The table stops at exactly ``N_MERGES``; ``rare`` are
    ``n_rare`` further words that it splits into pieces."""
    rng = random.Random(sub_seed(merge_seed, "words"))
    seen = set()

    def fresh() -> str:
        while True:
            n_syl = rng.choice((1, 2, 2, 3, 3, 4))
            w = "".join(rng.choice(_ONSETS) + rng.choice(_VOWELS) + rng.choice(_CODAS) for _ in range(n_syl))
            if w not in seen:
                seen.add(w)
                return w

    words: List[str] = []
    merges: List[Tuple[str, str]] = []
    rank: Dict[Tuple[str, str], int] = {}
    while len(merges) < N_MERGES:
        w = fresh()
        parts = bpe_word(w, rank)
        if len(parts) == 1:
            words.append(w)
            continue
        if len(merges) + len(parts) - 1 > N_MERGES:
            # the last merges start this word without finishing it
            parts = parts[: N_MERGES - len(merges) + 1]
        else:
            words.append(w)
        left = parts[0]
        for right in parts[1:]:
            rank[(left, right)] = len(merges)
            merges.append((left, right))
            left += right
    return words, [fresh() for _ in range(n_rare)], merges


# ---------------------------------------------------------------------------
# Query strings
# ---------------------------------------------------------------------------


def _zipf_weights(n: int, s: float) -> List[float]:
    return [1.0 / (r + 1) ** s for r in range(n)]


def accession(rng: random.Random) -> str:
    """A catalogue number: 4 + 4 + 4 digits (every digit is one token)."""
    return "%04d.%04d.%04d" % (rng.randrange(1500, 2030), rng.randrange(10000), rng.randrange(10000))


ACCESSION_TOKENS = 14  # 12 digits and two dots


class QueryMaker:
    """Catalogue-style queries of ``words`` words whose token count is known
    before tokenizing: each common word's count comes from the reference
    tokenizer once, an accession number is 14 tokens."""

    def __init__(self, words: Sequence[str], counts: Sequence[int], zipf_s: float):
        self.words = list(words)
        self.counts = list(counts)
        self.cum = list(np.cumsum(_zipf_weights(len(words), zipf_s)))

    def query(self, rng: random.Random, n_words: int, n_numbers: int) -> Tuple[str, int]:
        """``(text, tokens)``: ``tokens`` counts SOT and EOT, before truncation."""
        picks = rng.choices(range(len(self.words)), cum_weights=self.cum, k=n_words - n_numbers)
        parts = [self.words[i] for i in picks]
        tokens = 2 + sum(self.counts[i] for i in picks)
        for _ in range(n_numbers):
            parts.insert(rng.randrange(len(parts) + 1), accession(rng))
            tokens += ACCESSION_TOKENS
        return " ".join(parts), tokens


def query_batches(maker: QueryMaker, seed: int, traffic: dict, n_batches: int) -> List[Tuple[int, List[str]]]:
    """``n_batches`` batches of ``traffic["batch"]`` queries as ``(bucket,
    queries)``. The buckets cycle through the mix's fixed multiset, shuffled
    per cycle from the seed, so every seed has the same share of each.
    Every query fits its batch's bucket (the 77 bucket takes any length:
    the tokenizer truncates) and one query per batch needs the bucket."""
    rng = random.Random(sub_seed(seed, "queries"))
    cycle = [int(c["bucket"]) for c in traffic["batch_mix"] for _ in range(int(c["batches"]))]
    classes = {int(c["bucket"]): c for c in traffic["batch_mix"]}
    buckets = sorted(classes)
    out = []
    order: List[int] = []
    while len(out) < n_batches:
        if not order:
            order = cycle[:]
            rng.shuffle(order)
        b = order.pop()
        c = classes[b]
        floor = max([x for x in buckets if x < b], default=0)
        lo, hi = c["words"]
        queries = []
        longest_at = rng.randrange(traffic["batch"])
        for i in range(traffic["batch"]):
            need_floor = i == longest_at
            while True:
                n_words = rng.randint(lo, hi)
                n_numbers = min(n_words, rng.choice(c.get("numbers", [0])))
                text, tokens = maker.query(rng, n_words, n_numbers)
                fits = tokens <= b or b >= CONTEXT
                if fits and (not need_floor or tokens > floor):
                    break
            queries.append(text)
        out.append((b, queries))
    return out


# ---------------------------------------------------------------------------
# Training records
# ---------------------------------------------------------------------------


def train_records(seed: int, traffic: dict, image_resolution: int, maker: QueryMaker, device) -> List[dict]:
    """``traffic["records"]`` image-description-query triplets: uint8 RGB
    images at the traffic's source aspect (drawn on ``device`` in one
    call), a short query and a longer description from the same words."""
    n = int(traffic["records"])
    h = int(round(image_resolution * traffic["source_aspect"][0]))
    w = int(round(image_resolution * traffic["source_aspect"][1]))
    g = generator(seed, "images", device)
    imgs = torch.randint(0, 256, (n, h, w, 3), generator=g, device=device, dtype=torch.uint8).cpu().numpy()
    rng = random.Random(sub_seed(seed, "records"))
    records = []
    for i in range(n):
        q, _ = maker.query(rng, rng.randint(*traffic["query_words"]), 0)
        t, _ = maker.query(rng, rng.randint(*traffic["description_words"]), rng.choice(traffic["numbers"]))
        records.append({"image": imgs[i], "query_text": q, "target_text": t, "uuid": f"rec-{i:06d}"})
    return records
