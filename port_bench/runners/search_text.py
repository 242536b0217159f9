"""Text search, closed loop: batches of catalogue-style queries stream
through ``CLIPRetrieval.retrieval_batches`` (tokenize, text tower, blended
top-k over the corpus, uuid mapping), ``depth`` batches in flight, for the
window's seconds.

A batch's latency runs from its dispatch (before it is tokenized) to its
ranked uuid lists; ``search_qps`` counts every query completed over the
whole window, which ends when the last batch dispatched in it completes.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from .. import gen
from ..yardstick import percentile
from .common import free, port_model, vocabulary


def setup(run) -> None:
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import clip_retrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    tr, a, dev, seed = run.traffic, run.arch, run.device, run.seed
    # inputs, from the seed
    merges, maker, _ = vocabulary(tr)
    pool = gen.query_batches(maker, seed, tr, tr["pool_batches"])
    rows = tr["corpus_rows"]
    image = gen.corpus_host(seed, "image", rows, a.embed_dim, dev)
    text = gen.corpus_host(seed, "text", rows, a.embed_dim, dev)
    uuids = gen.uuids(seed, rows)
    weights = gen.clip_weights(a, seed, dev)
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the program
    model = port_model(a, weights)
    del weights
    retr = clip_retrieval.CLIPRetrieval(
        model, CLIPTokenizer(merges), EmbeddingStore(image=image, text=text, uuids=uuids), device=dev,
        top_k=tr["k"], use_fused_encoder=True, quantize=tr["quantize"], quantize_corpus=tr["quantize_corpus"],
    )
    del image, text
    st = run.state = SimpleNamespace(retr=retr, pool=pool, capture=False, sampled=set(), queries={}, ids={}, q={},
                                     results={}, buckets=[])
    S, P = run.spans, run.patches

    def keep(store, name):
        def info(args, kwargs, out):  # the outputs of the batches the check samples
            i = len(S.host[name]) - 1
            if st.capture and i in st.sampled:
                store[i] = out
        return info

    P.wrap(S, retr, "_tokenize", "tokenize", keep(st.ids, "tokenize"))
    P.wrap(S, retr, "_encode_ids", "encode", keep(st.q, "encode"))
    P.wrap(S, retr, "_score", "scan")
    P.wrap(S, retr, "_finish_results", "finish")
    P.wrap(S, fast_encode, "fused_layer_q8", "b1",
           lambda args, kw, out: (args[0].shape[0], args[3].shape[0], args[11].shape[1], kw["seq_len"], kw["mask_len"]))
    P.wrap(S, clip_retrieval, "fused_similarity_topk_q8", "b2",
           lambda args, kw, out: (args[0].shape[0], args[1].shape[0], args[1].shape[1], kw["k"]))
    # warm up: two batches of every bucket the mix sends, through the window's own call
    warm = []
    for b in sorted({b for b, _ in pool}):
        warm += [qs for bb, qs in pool if bb == b][:2]
    for _ in retr.retrieval_batches(warm, alpha=tr["alpha"], top_k=tr["k"], depth=tr["depth"]):
        pass


def window(run, seconds: float, check: bool) -> None:
    st, tr = run.state, run.traffic
    every = int(tr["check"]["sample_every"])
    t_disp, t_done, seen = [], [], set()
    st.capture, st.buckets = check, []

    def feed():
        i = 0
        while time.perf_counter() < stop:
            b, qs = st.pool[i % len(st.pool)]
            if check and (b not in seen or gen.sub_seed(run.seed, "sample", i) % every == 0):
                seen.add(b)
                st.sampled.add(i)
                st.queries[i] = qs
            st.buckets.append(b)
            t_disp.append(time.perf_counter())
            yield qs
            i += 1

    t0 = time.perf_counter()
    stop = t0 + seconds
    for j, res in enumerate(st.retr.retrieval_batches(feed(), alpha=tr["alpha"], top_k=tr["k"], depth=tr["depth"])):
        t_done.append(time.perf_counter())
        if check and j in st.sampled:
            st.results[j] = res
    st.capture = False
    run.window_s = t_done[-1] - t0
    n = len(t_done)
    run.counts.update(attempted=len(t_disp) * tr["batch"], failed=(len(t_disp) - n) * tr["batch"], batches=n,
                      queries=n * tr["batch"])
    run.metrics["search_qps"] = n * tr["batch"] / run.window_s
    run.metrics["search_p95_ms"] = percentile([d - s for s, d in zip(t_disp, t_done)], 95) * 1e3
    mix = {b: st.buckets.count(b) for b in sorted(set(st.buckets))}
    host = {k: round(sum(v) / n * 1e3, 3) for k, v in run.spans.host.items()}
    print(f"search: {n} batches of {tr['batch']} in {run.window_s:.3f} s; bucket mix {mix}; "
          f"host ms a batch in each span {host}", file=sys.stderr)


def release(run) -> None:
    """Free the program; keep what the check reads, on the host."""
    st = run.state
    run.patches.restore()
    st.q = {i: q.float().cpu() for i, q in st.q.items()}
    st.retr = None
    free(run.device)
