"""The seeded merge table and queries: the published vocabulary size, the
same ids from the same seed, the bucket mix, and the reference tokenizer
against the port's."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from port_bench import gen
from port_bench.runners.common import vocabulary
from port_bench.reference.bpe import trim_to_bucket

TRAFFIC = json.loads((Path(__file__).resolve().parent.parent / "traffic" / "search.text.1m.json").read_text())
SMALL = dict(TRAFFIC, batch=32)


@pytest.fixture(scope="module")
def vocab():
    return vocabulary(TRAFFIC)


def test_merge_table_has_clips_size(vocab):
    merges, _, tok = vocab
    assert len(merges) == 48_894
    assert len(tok.ids) == 49_408 and tok.eot == 49_407


def test_common_words_are_one_token(vocab):
    words, rare, _ = gen.word_list(0, 4000)
    _, _, tok = vocab
    counts = collections.Counter(tok.count(w) - 2 for w in words[:2000])
    assert counts[1] >= 1990
    assert all(tok.count(w) - 2 >= 2 for w in rare[:200])


def test_same_seed_same_ids(vocab):
    _, maker, tok = vocab
    a = gen.query_batches(maker, 2 ** 31 + 11, SMALL, 16)
    b = gen.query_batches(maker, 2 ** 31 + 11, SMALL, 16)
    c = gen.query_batches(maker, 2 ** 31 + 12, SMALL, 16)
    assert a == b and a != c
    ids_a = [trim_to_bucket(tok(q), (16, 32, 64, 77)) for _, q in a]
    ids_b = [trim_to_bucket(tok(q), (16, 32, 64, 77)) for _, q in b]
    assert all(np.array_equal(x, y) for x, y in zip(ids_a, ids_b))


def test_bucket_mix_is_the_mix_for_every_seed(vocab):
    _, maker, tok = vocab
    want = {c["bucket"]: c["batches"] for c in TRAFFIC["batch_mix"]}
    for seed in (1, 2 ** 31 + 3):
        batches = gen.query_batches(maker, seed, SMALL, 16)
        assert collections.Counter(b for b, _ in batches) == want
        for b, q in batches:  # every batch lands in its bucket
            assert trim_to_bucket(tok(q), sorted(want)).shape[1] == b


def test_reference_tokenizer_equals_the_ports(vocab):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer, trim_to_bucket as ptrim

    merges, maker, tok = vocab
    batches = gen.query_batches(maker, 7, SMALL, 16)
    for native in (True, False):
        port = CLIPTokenizer(merges, use_native=native or None)
        for b, q in batches:
            assert np.array_equal(ptrim(port(q)), trim_to_bucket(tok(q), (16, 32, 64, 77)))
