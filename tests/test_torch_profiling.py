"""The port's span and counter recorder (``utils.profiling``) and the spans
the program opens in a search batch, a train step and set-up.

The recorder is process-wide; every test here leaves it off and empty.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import profiling as P
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]


@pytest.fixture(autouse=True)
def recorder():
    P.enable(False)
    P.reset()
    yield
    P.enable(False)
    P.reset()


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_off_is_a_noop():
    a, b = P.span("x"), P.span("y", id=3)
    assert a is b  # one shared object: nothing allocated a call
    with a as got:
        assert got is None
    P.count("c", 5)

    @P.spanned("f")
    def f(x):
        return x + 1

    assert f(1) == 2
    assert P.snapshot() == {"spans": {}, "counters": {}} and P.finished() == []


def test_nesting_parents_self_time_and_ids():
    P.enable()
    with P.span("outer", id=7):
        time.sleep(0.002)
        with P.span("inner"):
            time.sleep(0.004)
        with P.span("other", id=9):
            pass
    spans = by_name(P.finished())
    outer, inner, other = spans["outer"][0], spans["inner"][0], spans["other"][0]
    assert outer.parent is None and inner.parent == "outer" and other.parent == "outer"
    assert (outer.id, inner.id, other.id) == (7, 7, 9)  # a span given no id takes its parent's
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= other.start_ns < other.end_ns <= outer.end_ns
    assert outer.thread == inner.thread == threading.get_ident()
    snap = P.snapshot()["spans"]
    assert snap["outer"]["calls"] == 1
    assert snap["outer"]["total_ns"] == outer.end_ns - outer.start_ns
    children = sum(s.end_ns - s.start_ns for s in (inner, other))
    assert snap["outer"]["self_ns"] == snap["outer"]["total_ns"] - children
    assert snap["inner"]["self_ns"] == snap["inner"]["total_ns"] >= 4_000_000
    assert snap["outer"]["self_ns"] >= 2_000_000


def test_aggregates_counters_and_reset():
    P.enable()
    for i in range(5):
        with P.span("s", id=i):
            pass
    P.count("words", 10)
    P.count("words", 2)
    P.count("misses")
    snap = P.snapshot()
    assert snap["spans"]["s"]["calls"] == 5
    assert snap["spans"]["s"]["total_ns"] == sum(s.end_ns - s.start_ns for s in P.finished())
    assert [s.id for s in P.finished()] == [0, 1, 2, 3, 4]
    assert snap["counters"] == {"words": 12, "misses": 1}
    P.reset()
    assert P.snapshot() == {"spans": {}, "counters": {}} and P.finished() == []


def test_the_buffer_is_bounded_and_the_aggregates_are_not(monkeypatch):
    rec = P.Recorder(capacity=4)
    monkeypatch.setattr(P, "RECORDER", rec)
    P.enable()
    for i in range(10):
        with P.span("s", id=i):
            pass
    assert [s.id for s in P.finished()] == [6, 7, 8, 9]  # the newest
    assert P.snapshot()["spans"]["s"]["calls"] == 10


def test_spanned_decorator_keeps_the_function():
    @P.spanned("f")
    def f(x, y=1):
        """doc"""
        with P.span("g"):
            return x + y

    assert f.__name__ == "f" and f.__doc__ == "doc"
    P.enable()
    assert f(1, y=2) == 3
    spans = by_name(P.finished())
    assert spans["g"][0].parent == "f" and spans["f"][0].parent is None


def test_two_threads_keep_their_own_stacks():
    P.enable()
    ready, go = threading.Barrier(2), threading.Event()

    def worker():
        with P.span("worker"):
            ready.wait(timeout=10)
            go.wait(timeout=10)
            with P.span("worker.child"):
                pass

    t = threading.Thread(target=worker)
    t.start()
    with P.span("main"):
        ready.wait(timeout=10)
        with P.span("main.child"):
            go.set()
            t.join(timeout=10)
    assert not t.is_alive()
    spans = by_name(P.finished())
    assert spans["worker.child"][0].parent == "worker" and spans["worker"][0].parent is None
    assert spans["main.child"][0].parent == "main"
    assert spans["worker"][0].thread != spans["main"][0].thread
    # the worker's spans are no children of the main thread's
    snap = P.snapshot()["spans"]
    main_child = spans["main.child"][0]
    assert snap["main"]["self_ns"] == snap["main"]["total_ns"] - (main_child.end_ns - main_child.start_ns)


def test_counters_and_aggregates_lose_no_update_under_threads():
    P.enable()
    n_threads, n = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                P.count("c")
                with P.span("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = P.snapshot()
    assert snap["counters"]["c"] == n_threads * n
    assert snap["spans"]["s"]["calls"] == n_threads * n


def test_spans_line_up_with_their_profiler_events():
    """Under a CPU ``torch.profiler`` session a span around a 1 ms sleep
    starts and ends within 50 us of its ``kemr:`` event (the median of five
    spans: one preemption of a loaded host does not decide it)."""
    P.enable()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("warm"):  # the profiler's first range costs more
            pass
        for i in range(5):
            with P.span(f"sleep{i}"):
                time.sleep(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("kemr:sleep")}
    assert len(events) == 5
    mine = by_name(P.finished())
    starts = sorted(abs(events[f"kemr:sleep{i}"].start_ns() - mine[f"sleep{i}"][0].start_ns) for i in range(5))
    ends = sorted(abs(events[f"kemr:sleep{i}"].end_ns() - mine[f"sleep{i}"][0].end_ns) for i in range(5))
    assert starts[2] < 50_000 and ends[2] < 50_000
    # without the recorder the profiler sees no kemr: range
    P.enable(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("sleep"):
            time.sleep(0.001)
    assert not [e for e in prof.profiler.kineto_results.events() if e.name().startswith("kemr:")]


# ---------------------------------------------------------------------------
# the program's spans and counters
# ---------------------------------------------------------------------------


def test_tokenizer_counts_words_and_misses_a_call():
    tok = CLIPTokenizer(MERGES)
    P.enable()
    tok(["cat hello", "cat he cat"])
    c = P.snapshot()["counters"]
    # words: cat, hello / cat, he, cat; misses: cat, hello, he
    assert c == {"tokenizer.words": 5, "tokenizer.bpe_misses": 3}
    P.reset()
    tok(["cat hello he"])
    assert P.snapshot()["counters"] == {"tokenizer.words": 3}  # every word from the cache: no miss
    # the pure-Python merge leaves a one-character word uncached: each of its calls is a miss
    tok = CLIPTokenizer(MERGES)
    tok._native = None
    P.reset()
    tok(["a a"])
    tok(["a"])
    assert P.snapshot()["counters"] == {"tokenizer.words": 3, "tokenizer.bpe_misses": 3}
    assert tok.encode("cat hello") == tok(["cat hello"])[0, 1:-1][:len(tok.encode("cat hello"))].tolist()


def test_the_kernel_build_is_a_span_only_when_it_compiles(monkeypatch, tmp_path):
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(dispatch, "library_path", lambda: lib)
    monkeypatch.setattr(dispatch, "_compile_library", lambda out, verbose: out.write_bytes(b""))
    P.enable()
    assert dispatch.build_library() == lib
    assert dispatch.build_library() == lib  # the library is there: nothing compiles
    assert P.snapshot()["spans"]["kernels.build"]["calls"] == 1


def tiny_arch():
    return TM.CLIPArch(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64, vision_patch_size=16,
                       context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2,
                       vision_heads=2)


def tiny_retriever():
    rng = np.random.default_rng(3)
    n, d = 200, 32
    unit = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    store = EmbeddingStore(image=unit(rng.standard_normal((n, d))), text=unit(rng.standard_normal((n, d))),
                           uuids=[f"u{i}" for i in range(n)])
    model = TM.build_model("tiny", dtype=torch.float32, seed=1, arch=tiny_arch())
    return CLIPRetrieval(model, CLIPTokenizer(MERGES), store, device="cpu", top_k=5, use_fused_encoder=True,
                         quantize="int8", quantize_corpus="int8", capacity_multiple=64)


BATCHES = [["cat", "hello cat he"], ["he he", "cat cat cat"], ["hello"], ["cat he", "he"], ["cat"]]


def test_search_spans_once_a_batch_with_its_ordinal():
    torch.manual_seed(0)
    r = tiny_retriever()
    off = list(r.retrieval_batches(BATCHES, top_k=5, depth=2))
    P.enable()
    on = list(r.retrieval_batches(BATCHES, top_k=5, depth=2))
    assert on == off  # uuids and scores bit-equal with the recorder on
    spans = by_name(P.finished())
    n = len(BATCHES)
    for name, parent in [("retrieval.dispatch", None), ("retrieval.tokenize", "retrieval.dispatch"),
                         ("retrieval.encode", "retrieval.dispatch"), ("retrieval.scan", "retrieval.dispatch"),
                         ("retrieval.finish", None), ("retrieval.fetch", "retrieval.finish"),
                         ("retrieval.map", "retrieval.finish")]:
        assert sorted(s.id for s in spans[name]) == list(range(n)), name
        assert {s.parent for s in spans[name]} == {parent}, name
    # the int8 layer kernel's wrapper (B1; here its plain route) once a layer a batch, under the batch's encode
    b1 = spans["kernel.fused_layer_q8"]
    assert sorted(s.id for s in b1) == sorted(list(range(n)) * tiny_arch().text_layers)
    assert {s.parent for s in b1} == {"retrieval.encode"}
    c = P.snapshot()["counters"]
    assert c["tokenizer.words"] == sum(len(q.split()) for b in BATCHES for q in b)
    assert "tokenizer.bpe_misses" not in c  # the first stream filled the cache: no miss counted


@pytest.mark.parametrize("depth", [1, 3])
def test_fetch_counts_once_a_finished_batch(depth):
    r = tiny_retriever()
    off = list(r.retrieval_batches(BATCHES, top_k=5, depth=depth))
    assert P.snapshot()["counters"] == {}  # off: nothing counted
    P.enable()
    assert list(r.retrieval_batches(BATCHES, top_k=5, depth=depth)) == off
    c = P.snapshot()["counters"]
    # the CPU search is done when its batch is dispatched: every fetch finds it ready
    assert (c.get("retrieval.fetch_ready"), c.get("retrieval.fetch_waited")) == (len(BATCHES), None)
    list(r.search_batches_pipelined(BATCHES[:2], top_k=5, depth=depth))
    r.retrieval_batch(BATCHES[0], top_k=5)
    assert P.snapshot()["counters"]["retrieval.fetch_ready"] == len(BATCHES) + 3


def test_set_up_installs_the_corpus_in_a_span():
    P.enable()
    r = tiny_retriever()
    snap = P.snapshot()["spans"]
    assert snap["retrieval.install_corpus"]["calls"] == 1
    r.remove_documents(["u0"])
    assert P.snapshot()["spans"]["retrieval.install_corpus"]["calls"] == 2


def tiny_step(on: bool):
    arch = TM.CLIPArch(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=32, vision_patch_size=16,
                       context_length=16, vocab_size=300, text_width=32, text_heads=2, text_layers=1,
                       vision_heads=2)
    model = TM.build_model("tiny", dtype=torch.float32, seed=2, arch=arch)
    cfg = TrainConfig(batch_size=4, lr=1e-3, ema_decay=0.9)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TT.TrainState(model, TT.make_optimizer(cfg, 10, model), 5, ema)
    step = TT.make_train_step(model, cfg)
    g = torch.Generator().manual_seed(0)
    batches = [{"images": torch.randn(4, 32, 32, 3, generator=g),
                "query_ids": torch.randint(1, 300, (4, 16), generator=g),
                "target_ids": torch.randint(1, 300, (4, 16), generator=g)} for _ in range(2)]
    P.enable(on)
    feed = TT.device_prefetch(iter(batches), lambda b: b)
    metrics = []
    for b in feed:
        state, m = step(state, b)
        metrics.append({k: v.item() for k, v in m.items()})
    P.enable(False)
    return state, metrics


def test_train_spans_once_a_step_with_its_number():
    s_off, m_off = tiny_step(False)
    assert P.finished() == []
    s_on, m_on = tiny_step(True)
    assert m_on == m_off
    for (n, a), b in zip(s_on.model.named_parameters(), s_off.model.parameters()):
        assert torch.equal(a, b), n  # bit-equal with the recorder on
    spans = by_name(P.finished())
    for name, parent in [("train.step", None), ("train.forward", "train.step"), ("train.backward", "train.step"),
                         ("train.grad_norm", "train.step"), ("train.optimizer", "train.step"),
                         ("train.ema", "train.step")]:
        assert [s.id for s in spans[name]] == [5, 6], name  # state.step at the step's start
        assert {s.parent for s in spans[name]} == {parent}, name
    # the feed: a wait on the consumer's thread a batch (and one for the end), a place on the worker's
    assert len(spans["train.feed.wait"]) == 3 and len(spans["train.feed.place"]) == 2
    assert {s.thread for s in spans["train.feed.place"]} != {s.thread for s in spans["train.step"]}
