#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device (exits non-zero without one) and prints the
   card's name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``knowledge_enhanced_multimodal_retrieval_tpu_torch/csrc``.
3. Runs each kernel of the text-query search path at ViT-L/14 text shapes
   (8,192 rows x 768, 12 heads, ff 3072; corpus 43,000 x 768, Q = 256,
   k = 20) against its plain PyTorch version on the same inputs, and times
   both with CUDA events (medians).
4. Serves the slice: ViT-L/14 text towers from seeded weights in the
   ``fast`` (bf16 encoder + bf16 corpus) and ``int8`` (W8A8 encoder + int8
   corpus) modes over a 43,000-row synthetic store saved to ``.npz`` and
   loaded back, answering 256-query batches and single knowledge-enhanced
   queries; checks the results and that every kernel of the path launched.

The last three lines of standard output are the nvidia-smi line, one JSON
object with the kernel table, and ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "knowledge_enhanced_multimodal_retrieval_tpu_torch"
ROWS, SEQ, WIDTH, HEADS, FF = 256 * 32, 32, 768, 12, 3072
CORPUS, QUERIES, K = 43_000, 256, 20
MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]  # synthetic BPE table (no CLIP vocab in the repo)

# Kernel vs plain tolerances, in absolute output units.
# bf16 blocks: outputs are |x| < 8 in bf16 (step 2^-5 there); kernel and
# plain version round at the same points but sum in another order, which
# can move a value by one step at each of the two roundings that reach it.
TOL_BF16_BLOCK = 2 * 2.0 ** -5
# int8 layer: the same plus a flipped int8 rounding of an activation
# (a few 1e-3 after the next projection), so two more bf16 steps.
TOL_Q8_LAYER = 4 * 2.0 ** -5
# top-k values: f32 sums of exact products in another order (~1e-7 rel).
TOL_TOPK = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def topk_agree(got, scores, k: int, tol: float):
    """The kernel's top-k is a correct top-k of the plain score matrix up to
    near ties: its values match the plain top-k values, every returned row
    really has the value reported for it, and no row repeats. Returns the
    plain top-k."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.similarity import topk_plain

    want = topk_plain(scores, k)
    gv, gi = got[0].float().cpu().numpy(), got[1].long().cpu().numpy()
    wv = want[0].float().cpu().numpy()
    s = scores.float().cpu().numpy()
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)
    np.testing.assert_allclose(np.take_along_axis(s, gi, 1), gv, rtol=tol, atol=tol)
    assert all(len(set(r)) == k for r in gi.tolist()), "a row repeats in a top-k list"
    return want


def kernel_phases(torch, dev, results):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM

    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32

    def t(a, dtype):
        return torch.tensor(np.asarray(a, np.float32)).to(dev, dtype).contiguous()

    x = t(rng.standard_normal((ROWS, WIDTH)), bf)
    ln = dict(ln_scale=t(1 + 0.1 * rng.standard_normal(WIDTH), f32), ln_bias=t(0.1 * rng.standard_normal(WIDTH), f32))
    w = dict(
        wqkv=rng.standard_normal((WIDTH, 3 * WIDTH)) * 0.02, bqkv=0.02 * rng.standard_normal(3 * WIDTH),
        wo=rng.standard_normal((WIDTH, WIDTH)) * 0.02, bo=0.02 * rng.standard_normal(WIDTH),
        w1=rng.standard_normal((WIDTH, FF)) * 0.02, b1=0.02 * rng.standard_normal(FF),
        w2=rng.standard_normal((FF, WIDTH)) * 0.02, b2=0.02 * rng.standard_normal(WIDTH),
    )
    wb = {k: t(v, f32 if k.startswith("b") else bf) for k, v in w.items()}
    attn_kw = dict(seq_len=SEQ, heads=HEADS, mask_len=SEQ, causal=True)

    def record(name, src, replaces, got, want, tol, kernel_fn, plain_fn):
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        log(f"{name}: max_abs_err {err:.6g} (tolerance {tol:.6g})")
        if not np.isfinite(err) or err > tol:
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
        ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
        log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (medians of 20, CUDA events)")
        results[name] = dict(name=name, route="cuda", source=src, replaces=replaces,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms)

    src_fb = f"{PKG}/csrc/fused_block.cu"
    ref_fb = "knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py"

    # B3a: attention block
    args = (x, ln["ln_scale"], ln["ln_bias"], wb["wqkv"], wb["bqkv"], wb["wo"], wb["bo"])
    record("B3a fused_attention_block", src_fb, f"{ref_fb}:139",
           FB.fused_attention_block(*args, **attn_kw), FB.attention_block_plain(*args, **attn_kw, eps=1e-5),
           TOL_BF16_BLOCK, lambda: FB.fused_attention_block(*args, **attn_kw),
           lambda: FB.attention_block_plain(*args, **attn_kw, eps=1e-5))

    # B3b: MLP block
    margs = (x, ln["ln_scale"], ln["ln_bias"], wb["w1"], wb["b1"], wb["w2"], wb["b2"])
    record("B3b fused_mlp_block", src_fb, f"{ref_fb}:226",
           FB.fused_mlp_block(*margs), FB.mlp_block_plain(*margs, eps=1e-5),
           TOL_BF16_BLOCK, lambda: FB.fused_mlp_block(*margs), lambda: FB.mlp_block_plain(*margs, eps=1e-5))

    # B1: whole int8 layer
    q = {k: FB.quantize_weight(t(w[k], f32)) for k in ("wqkv", "wo", "w1", "w2")}
    qargs = (x, ln["ln_scale"], ln["ln_bias"], *q["wqkv"], wb["bqkv"], *q["wo"], wb["bo"],
             ln["ln_scale"], ln["ln_bias"], *q["w1"], wb["b1"], *q["w2"], wb["b2"])
    got = FB.fused_layer_q8(*qargs, **attn_kw)
    want = FB.layer_q8_plain(*qargs, **attn_kw, n_chunks=FB.default_mlp_chunks(FF), eps=1e-5)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1).min().item()
    log(f"B1 fused_layer_q8: min row cosine to plain {cos:.6f}")
    assert cos > 0.999, cos
    record("B1 fused_layer_q8", src_fb, f"{ref_fb}:556", got, want, TOL_Q8_LAYER,
           lambda: FB.fused_layer_q8(*qargs, **attn_kw),
           lambda: FB.layer_q8_plain(*qargs, **attn_kw, n_chunks=FB.default_mlp_chunks(FF), eps=1e-5))

    # B2: blended top-k, exact (bf16 corpus) and q8 (int8 corpus)
    norm = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    img = norm(rng.standard_normal((CORPUS, WIDTH)))
    txt = norm(rng.standard_normal((CORPUS, WIDTH)))
    qs = t(norm(rng.standard_normal((QUERIES, WIDTH))), bf)
    alpha = t(rng.uniform(0.2, 0.8, QUERIES), f32)
    src_sim = f"{PKG}/csrc/similarity.cu"
    ref_sim = "knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py:680"
    ci, ct = t(img, bf), t(txt, bf)
    got = SIM.fused_similarity_topk(qs, ci, ct, K, alpha=alpha)
    want = topk_agree(got, SIM.blended_scores(qs, ci, ct, alpha), K, TOL_TOPK)
    record("B2 similarity_topk exact", src_sim, ref_sim, got[0], want[0], TOL_TOPK,
           lambda: SIM.fused_similarity_topk(qs, ci, ct, K, alpha=alpha),
           lambda: SIM.topk_plain(SIM.blended_scores(qs, ci, ct, alpha), K))
    iq, is_ = SIM.quantize_corpus_host(img)
    tq, ts = SIM.quantize_corpus_host(txt)
    c8 = (t(iq, torch.int8), t(is_, f32), t(tq, torch.int8), t(ts, f32))
    got = SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha)
    want = topk_agree(got, SIM.blended_scores_q8(qs, *c8, alpha), K, TOL_TOPK)
    record("B2 similarity_topk q8", src_sim, ref_sim, got[0], want[0], TOL_TOPK,
           lambda: SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha),
           lambda: SIM.topk_plain(SIM.blended_scores_q8(qs, *c8, alpha), K))
    torch.cuda.synchronize()


def _cpu_plan(plan):
    if isinstance(plan, dict):
        return {k: _cpu_plan(v) for k, v in plan.items()}
    if isinstance(plan, list):
        return [_cpu_plan(v) for v in plan]
    return plan.cpu()


def serve_phase(torch, dev, store_path, mode, results):
    """Drive the served slice in one mode; returns {wrapper: launches}."""
    from knowledge_enhanced_multimodal_retrieval_tpu.knowledge import (
        FakeKGSparqlClient,
        FakeLLMClient,
        Text2SparqlRetrieval,
    )
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import build_text_model
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import encode_text_fast
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    tok = CLIPTokenizer(MERGES)
    model = build_text_model("ViT-L/14", dtype=torch.bfloat16, seed=0, device=dev)
    store = EmbeddingStore.load(store_path)
    kw = dict(quantize="int8", quantize_corpus="int8") if mode == "int8" else dict(corpus_dtype=torch.bfloat16)
    retriever = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, **kw)
    llm_json = {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {"s": "DigitalArtefact", "p": "http://crm/P1", "o": "X_1",
                               "sType": ["http://kg/DigitalArtefact"]}}],
    }
    kg_hit = store.uuids[len(store) // 3]
    t2s = Text2SparqlRetrieval(FakeLLMClient({}, default=json.dumps(llm_json)),
                               FakeKGSparqlClient(entities={}, artefacts=[f"http://kg/artefact/{kg_hit}"]))
    engine = RetrievalEngine(retriever, t2s)
    rng = np.random.default_rng(1)
    words = ["cat", "hel", "hello", "ca", "he"]
    batches = [[" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)] for _ in range(3)]
    singles = ["hello cat", "he cat hel", "cat"]

    engine.retrieve_text_noknowledge_batch(batches[0])  # first call: kernel library load, allocator warm-up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    lat = []
    for b in batches:
        t0 = time.perf_counter()
        out = engine.retrieve_text_noknowledge_batch(b, alpha_clip=list(rng.uniform(0.2, 0.8, len(b))))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        assert len(out) == len(b)
        for r in out:
            scores = [x["score"] for x in r]
            assert len(r) == K and all(np.isfinite(scores)) and scores == sorted(scores, reverse=True)
            assert all(x["uuid"].startswith("uuid-") for x in r)
    for s in singles:
        fused = engine.retrieve_text(s)
        torch.cuda.synchronize()
        assert len(fused) == K and [x["score"] for x in fused] == sorted((x["score"] for x in fused), reverse=True)
    counts = dispatch.launch_counts()
    log(f"serve {mode}: launches {counts}")
    log(f"serve {mode}: 256-query batch latency median {np.median(lat) * 1e3:.2f} ms "
        f"({QUERIES / np.median(lat):.1f} queries/s; host clock around synchronize, 3 batches)")
    results[f"serve_{mode}_batch_ms"] = float(np.median(lat) * 1e3)

    # the search stage against its plain path on the same query embeddings
    # (rows must agree up to near ties), and the encoder against its plain
    # versions run on a CPU copy of the plan (cosine: bf16 / int8 rounding)
    c = retriever._corpus
    q = retriever.encode_queries(batches[1])
    got = retriever._score(c, q, 0.5, K)
    if mode == "int8":
        scores = SIM.blended_scores_q8(
            q.to(torch.bfloat16), c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, 0.5)
    else:
        scores = SIM.blended_scores(q.to(torch.bfloat16), c.corpus_img, c.corpus_txt, 0.5)
    topk_agree(got, scores, K, TOL_TOPK)
    ids = retriever._tokenize(batches[1][:16])
    q_cpu = encode_text_fast(model.arch, _cpu_plan(retriever._text_plan), torch.as_tensor(ids, dtype=torch.long))
    q_dev = encode_text_fast(model.arch, retriever._text_plan, torch.as_tensor(ids, dtype=torch.long, device=dev))
    cos = torch.nn.functional.cosine_similarity(q_dev.float().cpu(), q_cpu.float(), dim=-1).min().item()
    log(f"serve {mode}: search top-k == plain top-k; encoder cosine to plain (CPU) min {cos:.6f}")
    assert cos > 0.999, cos
    torch.cuda.synchronize()
    del engine, retriever, model
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = dispatch.build_library(verbose=True)
    dispatch.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    results = {}
    kernel_phases(torch, dev, results)

    rng = np.random.default_rng(2)
    norm = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store.npz")
        EmbeddingStore(
            image=norm(rng.standard_normal((CORPUS, WIDTH))),
            text=norm(rng.standard_normal((CORPUS, WIDTH))),
            uuids=[f"uuid-{i:06d}" for i in range(CORPUS)],
        ).save(store_path)
        fast = serve_phase(torch, dev, store_path, "fast", results)
        int8 = serve_phase(torch, dev, store_path, "int8", results)

    launches = {
        "B3a fused_attention_block": fast["fused_attention_block"],
        "B3b fused_mlp_block": fast["fused_mlp_block"],
        "B1 fused_layer_q8": int8["fused_layer_q8"],
        "B2 similarity_topk exact": fast["similarity_topk_kernel"],
        "B2 similarity_topk q8": int8["similarity_topk_kernel"],
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched while the slice was served")
        results[name]["launches"] = n
    kernels = [results[name] for name in launches]
    log(f"serve batch medians: fast {results['serve_fast_batch_ms']:.2f} ms, int8 {results['serve_int8_batch_ms']:.2f} ms")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
