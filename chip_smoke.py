#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Checks for a CUDA device (exits non-zero without one) and prints the
   card's name and power limit as nvidia-smi reports them.
2. Builds the hand-written kernels from ``knowledge_enhanced_multimodal_retrieval_tpu_torch/csrc``.
3. Runs each kernel against its plain PyTorch version on the same inputs,
   and times both with CUDA events (medians): the text-query search path at
   ViT-L/14 text shapes (8,192 rows x 768, 12 heads, ff 3072; corpus
   43,000 x 768, Q = 256, k = 20), and the corpus-precompute path at
   ViT-L/14 vision shapes (64 x 272 rows x 1024, 16 heads, ff 4096, not
   causal; 4 x 592 rows at 336 px; attention [64, 16, 257, 64] and
   [16, 16, 577, 64]). Correctness only: attention at head dims 32 and 128
   and under the causal mask, B2 at 1 and 3 queries and with text queries
   that differ from the image queries.
4. Serves the text slice: a seeded ViT-L/14 CLIP in the ``fast`` (bf16
   encoder + bf16 corpus) and ``int8`` (W8A8 encoder + int8 corpus) modes
   over a 43,000-row synthetic store saved to ``.npz`` and loaded back,
   answering 256-query batches and single knowledge-enhanced queries.
5. Precomputes corpus stores with ``cli.precompute.main`` on
   ``synthetic:300`` (batch 256, so the last batch is ragged) with the
   ``flax``, ``fast`` and ``int8`` encoders at ViT-L/14, and on
   ``synthetic:32`` at ViT-L/14@336px; the stores must agree row by row.
6. Answers 64 image queries over the 43,000-row store with the 300
   precomputed rows appended.
7. The compressed-corpus kernels against their plain versions: B2's int4
   mode and the PQ ADC scan B5 (M = 96, K = 256) at 43,000 and 1,000,000
   rows (random packed bytes and codes at 1M), Q = 256, k = 20; B5 also at
   k = 128 and 400 at 43,000 rows. B5's library yardstick is the JAX
   package's ADC formulation: per tower one bf16 product of the LUT
   [Q, M * K] with the one-hot codes (built outside the timed call at
   43,000 rows, in row chunks inside it at 1M), the scales, the blend and
   ``topk``.
8. Serves the compressed-corpus tiers over a clustered 43,000-row store
   (int4; pq; pq + OPQ; binary + rotation + rerank; int8 + truncate_dim 256
   + rerank; IVF over int8, int4 and pq lists from ``cli.index`` caches,
   nprobe 8), 3 batches of 256 queries each: launches, batch latency,
   served top-k against the plain top-k on the same query embeddings,
   reranked scores against the exact host rescore, recall@10 against the
   exact blended ranking for the text queries and for 256 corpus rows as
   queries (reported, not gated).
9. The per-block int8 route and the vision-interior profiler: B4a, B4b, S1
   (both interiors) and S2 (three flag settings) against their plain
   versions at 64 x 272 rows x 1024 (ff 4096), B4a and S1 also at 4 x 592
   rows; B4b(B4a(x)) == B1(x), S1 interior 0 == B4a and S2 gelu + requant
   == B4b bit for bit; ``scripts.profile_vision_interior.main`` at its
   defaults (seven medians at full ViT-L/14 vision width); and a vision
   tower whose int8 layers exceed the routing cap (width 1536, 24 heads,
   2 layers) through ``encode_image_fast``, batch 64: B4a and B4b launch
   once per layer, B1 never, the result equals the whole-layer route's and
   agrees with the same plan on the CPU.
Each kernel's line also carries its bound (the larger of bytes over
3.35 TB/s and operations over the card's peak for their type: 989 TFLOP/s
bf16, 1,979 TOP/s int8, 67 TFLOP/s f32 outside the tensor cores) and, where
one PyTorch call (or, for B2 and the layer kernels, a short sequence of
calls: ``F.layer_norm``, ``F.linear`` or ``torch._int_mm``,
``scaled_dot_product_attention``) computes the same function, that
sequence's time; the port calls none of them. ``ms``, ``plain_ms`` and ``library_ms`` are
medians of CUDA-event intervals around one call each, so they hold the
wrapper's host time where the card waits for it; ``device_ms`` and
``library_device_ms`` are the same medians with the card kept busy while
the host enqueues, which leaves the kernels' own time.
Each path runs with the launch counts set to 0 just before it and read
just after; every kernel must have launched in the path it belongs to.
10. The layer kernels' GEMM alone (correctness only): M, N and K that are no
   multiples of its tile, K = 384 and 512, every epilogue, bf16 and int8,
   against the plain version; the int8 results also bit for bit against the
   WMMA route, as is B1 at the text, vision and 336 px shapes.
11. One B3a, one B1 and one B3b call split by kernel name
   (``torch.profiler``) at the text and vision shapes (B3a and B1 also at
   336 px), with the rate each GEMM reaches; the text batch
   split into tokenize / encode / scan / uuid mapping; and the attention
   kernel against ``mha_plain`` at the text tower's shapes (what
   ``ops.attention.mha``'s routing rests on).
12. The layer kernels' attention interior alone (``ops.fused_block.attention_interior``)
   on a fixed ``qkv`` at the text, vision and 336 px shapes, both interiors:
   against its plain version, ``scaled_dot_product_attention`` on the same
   rows, the bound, and the one-warp-per-row route (forced) it replaced at
   these shapes; which route each shape took (the full-width shapes the
   wgmma route, a width-100 layer the other); and S1 interior 0 == B4a,
   B4b(B4a(x)) == B1(x) bit for bit at the text, vision and 336 px shapes.
13. B2 (exact, q8, q4) and B5 asked for k = 160 and 400 on the card: the
   kernels launch (running lists of up to 512 rows a pass), held to the
   plain top-k computed on the CPU (B5 bit for bit); and k = 600 on a
   smaller corpus, which runs as two passes: two launches. B2 q8 at k = 400
   over 43,000 rows is timed beside the plain version and the library
   sequence; the int8 + truncate_dim 256 + rerank tier serves once at the
   retriever's default top_k = 100 (a fetch of 400 rows), through B2.

14. The HTTP daemon (``daemon_phase``), built by ``cli.serve``'s own wiring
   at ViT-L/14 (``int8`` encoder, int8 corpus, ``--bucket-queries``,
   ``--warmup`` 1 ... 256, ``--max-pending``, ``--cache-results``) over the
   43,000-row store with the Text2SPARQL fakes, on 127.0.0.1, port 0: 32
   client threads x 20 requests, about 10 % ``/search_image`` (random 224 px
   PNGs), with the launch counts set to 0 just before and read just after
   (B1 once a layer for each text and image batch, B2 q8 once a batch);
   q/s, p50 / p95 / p99, batch-size histograms, real and padded rows; every
   ``/search`` answer against the engine called directly, filtered answers
   against the plain masked top-k on the same query embeddings, candidate
   answers against the exact host scores, ``/documents`` added, found and
   removed, ``/snapshot``, ``/healthz`` and ``/metrics``. Then 8 requests
   to a ``fast`` daemon with the exact corpus: B3a, B3b and B2 exact launch
   behind it.
15. Evaluation (``eval_phase``): ``cli.evaluate.main`` at ViT-L/14 on
   ``synthetic:1024`` with a Text2SPARQL results file (every 7th query's
   own artefact is a hit), once per encoder: ``flax`` (B6 once a layer on
   both towers), ``fast`` (B3a + B3b) and ``int8`` (B1), each launch counted
   per tower call; the serving encoders' embeddings against the module
   towers' at the stores' cosine bound; the ranks of every task on the card
   against the CPU on the same embeddings (rows within 1e-5 of a competitor
   excepted and counted). Then ``fusion_sweep`` (18 cells, stripes of 1,024
   queries) over 43,000 seeded 768-d rows on a 2^-9 grid (every product
   exact in f32) with 1 % of the queries carrying hits, timed per cell, and
   at 4,096 rows against the CPU: equal ranks in every cell.
16. Learned fusion (``fusion_phase``): ``cli.train_fusion.main`` (``int8``,
   ``simple_gated``, synthetic:512, B1 once a layer on both towers), the
   five other heads trained 2 epochs on the same frozen embeddings, every
   head's scores on the card against the CPU; then the daemon built by
   ``cli.serve``'s wiring with ``--fusion.head_params`` over the 43,000-row
   int8 store: 8 clients x 8 ``{"fused": true}`` requests (each one stage-1
   fetch of 400 rows through B2 q8), every answer against the engine called
   directly, requests/s and p50 / p99; the head's scores at top_k 20 and
   100 against the CPU head over the same candidates.
17. The quality sweep (``quality_phase``): the port's
   ``scripts/quality_sweep.py`` (``--nprobes 8``; its rotated and OPQ rows,
   ~65 s of host training, are left to the CPU tests) and
   ``scripts/autotune.py`` (``--no-rotate``) on the capacity tiers'
   clustered store, 256 corpus rows as queries, k = 10: B2 q8, B2-q4 and B5
   launch once a row and fetch; the int4 / pq recall against the
   served tiers' recall@10 on the same 256 rows (within 0.002); then
   ``scripts/consistency_check.py`` (the f32 ``flax`` path on the card
   against the CPU: cosine > 0.9999, the same metrics).
18. Checkpoint layouts (``checkpoint_layouts_phase``): the ViT-L/14 weights
   written by the port's writers (``models.convert``) as an OpenAI ``.pt``,
   an HF-layout state-dict ``.pt`` and a flax ``.npz`` (~1.7 GB each, in a
   temporary directory), each loaded through ``cli.common.build_model`` to
   parameters bit-identical to the written model; one 256-query ``int8``
   and one ``fast`` batch through each (rows equal, scores within 1e-5).
19. The parity runbook (``parity_phase``): ``cli.parity --dry-run`` with the
   JAX dry run's stage statuses; real mode with the ViT-L/14 ``.pt`` as
   ``CLIP_PT_PATH`` on ``synthetic:256`` in the ``flax`` / ``fast`` /
   ``int8`` encoders (``converter_openai`` and ``evaluation`` ``ok``), with
   ``CLIP_HF_PATH`` (an HF export of the same weights) for the first run
   only where ``transformers`` imports.
20. Text baselines (``baseline_phase``): ``evaluate_text_model`` (single,
   multi) and ``evaluate_lm_query_target`` with ``HashTextEncoder`` (768)
   at 4,300 artefacts x 5 variants on the card against the CPU: ranks
   equal but for near ties (1e-5), metrics within 1e-6 without them.
21. The profiling scripts (``profiling_scripts_phase``): ``scripts.{profile_serving,
   profile_vision, vision_batch_sweep, profile_pq, profile_ivf,
   scale_bench}.main`` once each at full width with repeats cut
   (``SCRIPT_RUNS``; ``profile_pq`` at 21,504 rows, ``profile_ivf`` at 4,096, ``scale_bench`` at 32,768), their JSON under
   ``chiprun_out/``; every line finite, the scans' recall checked.
22. Training (``train_phase``): ``cli.train`` at ViT-L/14 widths cut to 4
   vision and 2 text layers (bf16 compute, f32 parameters, batch 64,
   ``synthetic:128``): the reference-parity run (InfoNCE, t2i 0.7 / t2t 0.3,
   1 epoch, validation, latest / best checkpoints, metrics files) and its
   resume to 2 epochs, which must start at epoch 1; a variant (accumulation
   2, EMA 0.999, remat, FLIP 0.5: the vision tower at s = 129) whose
   ``load_params_only`` must return the EMA shadow, and a second one
   (SigLIP, Matryoshka 256 / 768, frozen image encoder), 1 epoch each;
   ``cli.export --format openai`` of the best checkpoint,
   loaded through ``load_clip_state_dict``, its module towers against the
   ``fast`` ones (cosine > 0.999), one 256-query ``fast`` batch over the
   43,000-row store; 8 steps of a seeded ViT-L/14 on one batch at a raised
   lr (the loss must fall, every loss finite); one bf16 and two f32 steps of ViT-L/14
   widths at 1 layer a tower, batch 4, on the card against the CPU; and
   ``scripts/train_bench.py``'s ViT-L/14 batch-64 point with and without
   remat (step ms, device ms, MFU; ``TRAIN_BENCH_STEPS`` steps). B6 must launch on the training forward
   of both towers, in validation and in the FLIP run.
23. The training variants (``train_variants_phase``), at ViT-L/14 widths cut
   to 4 + 2 layers: LoRA (rank 8, all four block projections) through
   ``cli.train``, batch 64, ``synthetic:128``, 2 epochs with validation,
   from a seeded OpenAI ``.pt``;
   ``cli.export --model.adapters`` of its adapters into that base (equal to
   the host merge; the card's merge within half a bf16 step of it), the
   merged model served (one 256-query ``int8`` batch: B1, B2 q8) against the
   plain top-k; GradCache (4 chunks) and QAT, 1 epoch each;
   ``cli.mine_negatives --eval.encoder=int8 --k=16`` (B1 on both towers; the
   card's table against a CPU mining of the same embeddings, near ties
   excepted) and ``cli.train`` with the table (k 4); ``cli.distill``
   (ViT-B/32 student, ``int8`` teacher, cosine term off), 1 epoch;
   ``scripts/qat_payoff.py`` at 3 epochs; one LoRA, QAT, GradCache and
   distill step of ViT-L/14 widths at 1 layer, batch 4, f32, on the card
   against the CPU. Step ms (events, steps 2..n) and peak memory per run.
24. Sharded serving (``sharded_serving_phase``, ROADMAP A5 (a)) over a mesh of
   ``[cuda:0] * 4`` at ViT-L/14 text width, 43,000 rows, 256-query batches,
   k = 20: ``CLIPRetrieval(shard_corpus=True)`` in the exact bf16 (``fast``),
   int8 (``int8``) and int4 tiers, each shard a row view of one staged copy
   and B2 launched once a shard, served, filtered and candidate answers
   against the same retriever unsharded (near ties excepted, scores to
   1e-5); ``sharded_pq_similarity_topk`` (B5 once a shard) and
   ``sharded_hamming_topk`` on the arrays the pq and binary tiers of item 8
   packed, against the one-shard calls; sharded IVF int8 over the clustered
   store at nlist 208 (207 snapped to the shards): at nprobe = nlist against
   the exact int8 scan, at nprobe 8 against the plain sharded version on the
   CPU; ``shard_queries`` with the ``int8`` and ``fast`` encoders (B1, or
   B3a + B3b, once a layer for each of the four query slices, B2 once a
   slice) against the whole batch under the int8 rules; B2 q8 at 1,000,000
   rows in 4 shards against the one-shard scan, timed beside it; two
   ``cli.serve --multihost`` processes over gloo on the one card (the corpus
   sharded over the two; rank 0 answers 16 queries from standard input) and
   a world-size-1 NCCL group driving ``MultiHostSearch`` in this process,
   both against the single-process retriever.
25. Parallel training (``parallel_training_phase``, ROADMAP A5 (b)) over
   ``[cuda:0] * 4``: f32 (TF32 off) steps of ViT-L/14 widths at 1 layer a
   tower, batch 16, global negatives: DP4, FSDP4, dp2 x tp2, fsdp + tp and
   dcn2 x dp2 against the one-device step (loss 1e-5, parameters 2e-5);
   DP4 with local negatives against the mean of its four shards' losses;
   LoRA, GradCache (2 chunks), mined negatives and distillation under DP4
   against their one-device steps; ViT-L/14 in bf16, batch 64, DP4, FSDP4
   and dp2 x tp2 (step ms, peak memory, FSDP's state a position a quarter of
   the replicated one to 1 %); two ``cli.train`` processes over gloo on the
   card against one process over ``[cuda:0] * 2`` (monitors, steps and stop
   decision equal on both ranks, parameters equal across ranks and to 1e-4
   of one process, metrics written by rank 0 only) and a world-size-1 NCCL
   step and encode; in the two ``cli.train`` ranks, over their gloo group
   (``pp_sp_ep_across_processes``), pipeline, sequence and expert
   parallelism with the axis across the processes (each rank's rows of the
   other's stages, shards or experts NaN) and dp2 x pp2 with ``data``
   across them: pp (ViT-L/14's 12 text blocks in 4 stages, 8 microbatches
   of [8, 77, 768], forward and gradients against the stack and the
   one-process pipeline; B6 counted in each rank), sp (ring attention
   [2, 12, 1024, 64] in f32 and bf16 against ``mha``, which launches B7,
   gradients against one process; a text block at s = 1024 against
   ``ResidualBlock``), ep (4 experts, 768 / 3072, 154 tokens, against the
   unsharded call, gradients too); the sharded
   ``int8`` encode over 4 shards against one device (cosine > 0.999, 99.5 %
   of values within 1e-3).
The kernel line's entries carry ``launches_by_path`` for the launches of
items 15-25 beside the earlier paths', and ``launches`` is their sum.

The last three lines of standard output are the nvidia-smi line, one JSON
object with the kernel table, and ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that last line.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "knowledge_enhanced_multimodal_retrieval_tpu_torch"
ROWS, SEQ, WIDTH, HEADS, FF = 256 * 32, 32, 768, 12, 3072
CORPUS, QUERIES, K = 43_000, 256, 20
V_WIDTH, V_HEADS, V_FF, V_SEQ, V_MASK, V_BATCH = 1024, 16, 4096, 272, 257, 64  # ViT-L/14 vision
V336_SEQ, V336_MASK = 592, 577  # ViT-L/14@336px
N_DOCS, IMAGE_QUERIES = 300, 64
SCALE_ROWS = 1_000_000  # the scale ladder's corpus size
PQ_M, PQ_K = 96, 256  # ViT-L/14 width / 8 subspaces, uint8 codes
NPROBE = 8
CAPACITY_TIERS = {
    "int4": dict(quantize_corpus="int4"),
    "pq": dict(quantize_corpus="pq"),
    "pq+opq": dict(quantize_corpus="pq", rotate="opq"),
    "binary+rotate+rerank": dict(quantize_corpus="binary", rotate=True, rerank=True),
    "int8+truncate256+rerank": dict(quantize_corpus="int8", truncate_dim=256, rerank=True),
    "ivf int8": dict(quantize_corpus="int8", ann="ivf"),
    "ivf int4": dict(quantize_corpus="int4", ann="ivf"),
    "ivf pq": dict(quantize_corpus="pq", ann="ivf"),
}
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
# attention (B6/B7), bf16: kernel and plain version both round the
# unnormalized p to bf16 before p@v, sum the f32 p and round the output once;
# the kernel rounds p against the running maximum and the plain version
# against the final one (2^-9 relative per weight, averaged over the keys),
# and the sums run in another order. Outputs |o| < 4 (step <= 2^-6 there):
# one step apart.
TOL_ATTN = 2.0 ** -6
# attention interior of the layer kernels, bf16: kernel and plain version both
# round the normalized p to bf16; the kernel's row sum runs in another order
# and its exponent is one fused multiply-add, so a p on a bf16 boundary can
# round the other way. Outputs |o| < 4 (a causal row's first keys: o is
# nearly one v row), step <= 2^-6 there: one step apart.
TOL_INTERIOR = 2.0 ** -6
# IVF probes, card against the CPU in f32: other summation orders (~1e-6);
# IVF-PQ also casts its LUTs to bf16, where an entry can round one step the
# other way (a few 1e-4 per entry, M entries per score).
TOL_IVF, TOL_IVF_PQ = 1e-4, 5e-3
# precompute stores and image queries: L2-normalized rows. Stores of two
# encoders agree per row at the int8 cosine bound; an image query finds its
# own row at 1 - (bf16 rounding of two unit vectors, ~2^-8, and cuBLAS
# algorithm choice by batch size in the patch matmul).
STORE_COS = 0.999
TOL_SELF = 1e-2

# Published peaks of one H100 SXM at its full power limit (NVIDIA's data
# sheet, dense): device memory bytes/s, bf16 and int8 tensor-core
# operations/s, f32 operations/s outside the tensor cores.
HBM_BYTES_S, BF16_OPS_S, INT8_OPS_S, F32_OPS_S = 3.35e12, 989e12, 1979e12, 67e12


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the least time the card could take. ``bytes_moved``
    counts each input read once and each output written once; ``ops`` is a
    list of (operations, peak rate for their type)."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, sum(n / rate for n, rate in ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def layer_bounds(rows, width, ff, seq_len, mask_len, causal):
    """Bounds of the layer kernels at one shape, from the shapes alone.
    A multiply-add is 2 operations. Attention: q.k and p.v over the keys a
    row may see (mask_len of them; on average (keys + 1) / 2 when causal)."""
    keys = min(seq_len, mask_len)
    attn = 4 * rows * width * ((keys + 1) / 2 if causal else keys)
    act = 2 * rows * width * 2  # x read, out written, bf16
    small = 4 * (6 * width + ff)  # LayerNorm vectors and biases, f32 (per half: less)
    wa, wm = 4 * width * width, 2 * width * ff  # weight elements of the two halves
    scales = 4 * (5 * width + ff)  # f32 per-output-channel scales
    pa, pm = 2 * rows * wa, 2 * rows * wm  # projection operations of the two halves
    return {
        "B3a": bound(act + 2 * wa + small, [(pa + attn, BF16_OPS_S)]),
        "B3b": bound(act + 2 * wm + small, [(pm, BF16_OPS_S)]),
        "B1": bound(act + wa + wm + scales + small, [(pa + pm, INT8_OPS_S), (attn, BF16_OPS_S)]),
        "B4a": bound(act + wa + scales + small, [(pa, INT8_OPS_S), (attn, BF16_OPS_S)]),
        "B4b": bound(act + wm + scales + small, [(pm, INT8_OPS_S)]),
        # S2 without requantization: c_proj is a bf16 product
        "S2-bf16": bound(act + wm + scales + small, [(pm / 2, INT8_OPS_S), (pm / 2, BF16_OPS_S)]),
    }


def topk_bound(q, n, d, k, corpus_bytes_per_row):
    """B2 in every mode: both towers' rows read once (``corpus_bytes_per_row``
    each, scales included), queries and alpha read, k (value, row) pairs
    written; two q x n x d products. The queries are bf16, so the products
    count at the bf16 rate whatever the corpus is stored in."""
    return bound(2 * n * corpus_bytes_per_row + q * d * 2 + q * 4 + q * k * 8, [(2 * 2 * q * n * d, BF16_OPS_S)])


def pq_bound(q, n, m, n_k, k):
    """B5: codes and scales of both towers, both LUTs (bf16) and alpha read,
    k pairs written; one f32 add per (query, row, subspace, tower) and the
    scale and blend per (query, row), outside the tensor cores."""
    return bound(2 * n * (m + 4) + 2 * m * q * n_k * 2 + q * 4 + q * k * 8, [(2 * q * n * m + 4 * q * n, F32_OPS_S)])


def attention_bound(b, h, s, d):
    """B6 / B7: q, k, v read and o written (bf16); q.k and p.v."""
    return bound(4 * b * h * s * d * 2, [(4 * b * h * s * s * d, BF16_OPS_S)])


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


def device_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event interval around one call while the card is still
    busy with a spin kernel queued just before: the host enqueues ahead of
    the card, so the interval holds no host time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of spinning on the card
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


def _t(torch, dev, a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dev, dtype).contiguous()


def record(torch, results, name, src, replaces, got, want, tol, kernel_fn, plain_fn, plain_iters=20, *,
           bound_of, library_fn=None):
    """Hold ``got`` to ``want``, time the kernel, its plain version and (where
    one PyTorch call computes the same function) that call, and keep the
    kernel's line. ``bound_of`` is ``bound(...)``'s pair for this shape."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    log(f"{name}: max_abs_err {err:.6g} (tolerance {tol:.6g})")
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn, iters=plain_iters, warmup=1 if plain_iters < 20 else 3)
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (medians of 20 / {plain_iters}, CUDA events)")
    library_ms = median_ms(library_fn) if library_fn is not None else None
    if library_fn is not None:
        lib_out = library_fn()
        if torch.is_tensor(lib_out) and lib_out.shape == got.shape:  # the same function, other roundings: reported
            log(f"{name}: library sequence vs kernel max_abs_diff {float((lib_out.float() - got.float()).abs().max()):.6g}")
    dev_ms = device_ms(kernel_fn)
    library_dev_ms = device_ms(library_fn) if library_fn is not None else None
    bound_ms, bound_by = bound_of
    log(f"{name}: bound {bound_ms:.4f} ms by {bound_by} ({ms / bound_ms:.1f}x over it); device only {dev_ms:.4f} ms"
        + (f"; library call {library_ms:.4f} ms (device only {library_dev_ms:.4f} ms)" if library_ms is not None else ""))
    results[name] = dict(name=name, route="cuda", source=src, replaces=replaces, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                         device_ms=dev_ms, library_device_ms=library_dev_ms)


SRC_FB = f"{PKG}/csrc/fused_block.cu"
REF_FB = "knowledge_enhanced_multimodal_retrieval_tpu/ops/fused_block.py"


def _layer_weights(torch, dev, rng, width, ff):
    f32, bf = torch.float32, torch.bfloat16
    ln = dict(ln_scale=_t(torch, dev, 1 + 0.1 * rng.standard_normal(width), f32),
              ln_bias=_t(torch, dev, 0.1 * rng.standard_normal(width), f32))
    w = dict(
        wqkv=rng.standard_normal((width, 3 * width)) * 0.02, bqkv=0.02 * rng.standard_normal(3 * width),
        wo=rng.standard_normal((width, width)) * 0.02, bo=0.02 * rng.standard_normal(width),
        w1=rng.standard_normal((width, ff)) * 0.02, b1=0.02 * rng.standard_normal(ff),
        w2=rng.standard_normal((ff, width)) * 0.02, b2=0.02 * rng.standard_normal(width),
    )
    wb = {k: _t(torch, dev, v, f32 if k.startswith("b") else bf) for k, v in w.items()}
    return ln, w, wb


def layer_library(torch, ln, ln2, wb, q, *, seq_len, heads, mask_len, causal, n_chunks):
    """The library yardsticks of the layer kernels: short sequences of
    PyTorch calls that compute the same functions (``F.layer_norm``,
    ``F.linear`` in bf16 or ``torch._int_mm`` with the row quantization in
    plain PyTorch, ``scaled_dot_product_attention``, QuickGELU, the residual
    add). Timed beside the kernels, not held to their rounding; the port
    never calls them. ``q`` maps a weight's name to ``(int8 [in, out],
    scales [1, out])`` or is None. Returns ``{name: fn(x)}``; ``"S2"`` is
    ``fn(x, gelu, requant)``."""
    F = torch.nn.functional
    bf = torch.bfloat16
    width = wb["wo"].shape[0]
    hd = width // heads
    oi = {k: wb[k].t().contiguous() for k in ("wqkv", "wo", "w1", "w2")}  # [out, in], as F.linear reads it
    bias = {k: wb[k].to(bf) for k in ("bqkv", "bo", "b1", "b2")}
    g1, c1 = ln["ln_scale"], ln["ln_bias"]
    g2, c2 = ln2["ln_scale"], ln2["ln_bias"]
    key_mask = None
    if mask_len < seq_len:
        key_mask = (torch.arange(seq_len, device=g1.device) < mask_len).view(1, 1, 1, seq_len)

    def sdpa(qkv):
        rows = qkv.shape[0]
        q_, k_, v_ = qkv.view(rows // seq_len, seq_len, 3, heads, hd).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=key_mask, is_causal=causal and key_mask is None)
        return o.permute(0, 2, 1, 3).reshape(rows, width)

    def attn(x):
        h = F.layer_norm(x, (width,), g1.to(bf), c1.to(bf), 1e-5)
        return x + F.linear(sdpa(F.linear(h, oi["wqkv"], bias["bqkv"])), oi["wo"], bias["bo"])

    def mlp(x):
        h = F.layer_norm(x, (width,), g2.to(bf), c2.to(bf), 1e-5)
        f = F.linear(h, oi["w1"], bias["b1"])
        return x + F.linear(f * torch.sigmoid(1.702 * f), oi["w2"], bias["b2"])

    fns = {"B3a": attn, "B3b": mlp}
    if q is None:
        return fns
    qt = {k: q[k][0].t().contiguous() for k in q}  # [out, in]: _int_mm reads its transpose view
    ck = qt["w1"].shape[0] // n_chunks
    w1_chunks = [qt["w1"][i * ck:(i + 1) * ck] for i in range(n_chunks)]
    w2_chunks = [qt["w2"][:, i * ck:(i + 1) * ck].contiguous() for i in range(n_chunks)]
    w2_bf = [q["w2"][0][i * ck:(i + 1) * ck].to(bf).t().contiguous() for i in range(n_chunks)]

    def quant(h):
        r = (h.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
        return torch.round(h / r).to(torch.int8), r

    def q8_linear(h, wt, ws):
        hq, r = quant(h)
        return torch._int_mm(hq, wt.t()).float() * r * ws

    def attn_q8(x):
        h = F.layer_norm(x.float(), (width,), g1, c1, 1e-5)
        qkv = (q8_linear(h, qt["wqkv"], q["wqkv"][1]) + wb["bqkv"]).to(bf)
        out = q8_linear(sdpa(qkv).float(), qt["wo"], q["wo"][1]) + wb["bo"]
        return x + out.to(bf)

    def mlp_q8(x, gelu=True, requant=True):
        hq, r = quant(F.layer_norm(x.float(), (width,), g2, c2, 1e-5))
        acc = None
        for i in range(n_chunks):
            sl = slice(i * ck, (i + 1) * ck)
            f = torch._int_mm(hq, w1_chunks[i].t()).float() * r * q["w1"][1][:, sl] + wb["b1"][sl]
            if gelu:
                f = f * torch.sigmoid(1.702 * f)
            if requant:
                part = q8_linear(f, w2_chunks[i], q["w2"][1])
            else:
                part = F.linear(f.to(bf), w2_bf[i]).float() * q["w2"][1]
            acc = part if acc is None else acc + part
        return x + (acc + wb["b2"]).to(bf)

    fns.update({"B4a": attn_q8, "B4b": mlp_q8, "S2": mlp_q8, "B1": lambda x: mlp_q8(attn_q8(x))})
    return fns


GEMM_EPILOGUES = {0: "bias", 1: "bias+residual", 2: "bias+gelu", 3: "bias+gelu f32", 4: "accumulate f32",
                  5: "bias f32", 6: "scale+accumulate f32"}


def kernel_split(torch, results, label, fn, gemm_ops, rounds=5):
    """One call of ``fn`` split by kernel name: ``torch.profiler`` around one
    call at a time, per name the median over ``rounds`` of the device time
    summed over the call's launches (a round that lost events, seen by its
    launch count, is left out). ``gemm_ops`` maps the GEMM's epilogue number
    to (role, operations in one call): the rate each reaches is printed
    beside its time."""
    import re
    from torch.profiler import ProfilerActivity, profile

    fn()
    seen = {}  # name -> [(launches, ms)] per round
    for _ in range(rounds):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            us = getattr(e, "cuda_time_total", 0.0) if us is None else us
            if us <= 0 or getattr(e, "device_type", None) is not None and "CUDA" not in str(e.device_type):
                continue
            seen.setdefault(e.key, []).append((e.count, us / 1e3))
    rows = []
    for key, per_round in seen.items():
        launches = max(n for n, _ in per_round)
        ms = float(np.median([t for n, t in per_round if n == launches]))
        name, note = key.split("(")[0].replace("void ", "").strip(), ""
        m = re.search(r"gemm_wg_kernel<(.+?), *(\d), *(.+?)>", name)
        if m:
            epi = int(m.group(2))
            unit = "TOP/s" if "char" in m.group(1) else "TFLOP/s"
            chunked = ", all chunks" if ("true" in m.group(3) or "1" in m.group(3)) else ""
            name = f"gemm_wg_kernel<{'int8' if 'char' in m.group(1) else 'bf16'}, {GEMM_EPILOGUES[epi]}{chunked}>"
            if epi in gemm_ops:
                role, ops = gemm_ops[epi]
                note = f" ({role}: {ops / (ms * 1e-3) / 1e12:.0f} {unit})"
        m = re.search(r"attention_(wg_)?kernel<(.+?)>", key)
        if m and "flash" not in key:
            nomax = ", no-max" if ("true" in m.group(2) or "1" in m.group(2)) else ""
            name = f"attention interior ({'wgmma' if m.group(1) else 'one warp per row'}{nomax})"
        rows.append((ms, f"{name} x{launches:g} {ms:.4f} ms{note}", name, launches))
    if not rows:
        raise AssertionError(f"{label}: torch.profiler recorded no device time")
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"split {label}: {total:.4f} ms of kernels a call: " + "; ".join(r[1] for r in rows))
    results.setdefault("splits", {})[label] = {r[2]: dict(ms=r[0], launches=r[3]) for r in rows}


def layer_phases(torch, dev, results, rng, *, rows, width, ff, attn_kw, tag, layers=("B3a", "B3b", "B1"), split=False):
    """B3a, B3b and B1 at one shape against their plain versions."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB

    x = _t(torch, dev, rng.standard_normal((rows, width)), torch.bfloat16)
    ln, w, wb = _layer_weights(torch, dev, rng, width, ff)
    bounds = layer_bounds(rows, width, ff, attn_kw["seq_len"], attn_kw["mask_len"], attn_kw["causal"])
    n_chunks = FB.default_mlp_chunks(ff)
    q = {k: FB.quantize_weight(_t(torch, dev, w[k], torch.float32)) for k in ("wqkv", "wo", "w1", "w2")}
    lib = layer_library(torch, ln, ln, wb, q, **attn_kw, n_chunks=n_chunks)
    routes_before = FB.attention_route_counts()
    if "B3a" in layers:
        args = (x, ln["ln_scale"], ln["ln_bias"], wb["wqkv"], wb["bqkv"], wb["wo"], wb["bo"])
        record(torch, results, f"B3a fused_attention_block{tag}", SRC_FB, f"{REF_FB}:139",
               FB.fused_attention_block(*args, **attn_kw), FB.attention_block_plain(*args, **attn_kw, eps=1e-5),
               TOL_BF16_BLOCK, lambda: FB.fused_attention_block(*args, **attn_kw),
               lambda: FB.attention_block_plain(*args, **attn_kw, eps=1e-5), bound_of=bounds["B3a"],
               library_fn=lambda: lib["B3a"](x))
        if split:
            kernel_split(torch, results, f"B3a{tag or ' text'}", lambda: FB.fused_attention_block(*args, **attn_kw),
                         {0: ("qkv", 6 * rows * width * width), 1: ("out-proj", 2 * rows * width * width)})
    if "B3b" in layers:
        margs = (x, ln["ln_scale"], ln["ln_bias"], wb["w1"], wb["b1"], wb["w2"], wb["b2"])
        record(torch, results, f"B3b fused_mlp_block{tag}", SRC_FB, f"{REF_FB}:226",
               FB.fused_mlp_block(*margs), FB.mlp_block_plain(*margs, eps=1e-5),
               TOL_BF16_BLOCK, lambda: FB.fused_mlp_block(*margs), lambda: FB.mlp_block_plain(*margs, eps=1e-5),
               bound_of=bounds["B3b"], library_fn=lambda: lib["B3b"](x))
        if split:
            kernel_split(torch, results, f"B3b{tag or ' text'}", lambda: FB.fused_mlp_block(*margs),
                         {2: ("c_fc", 2 * rows * width * ff), 1: ("c_proj", 2 * rows * width * ff)})
    if "B1" in layers:
        qargs = (x, ln["ln_scale"], ln["ln_bias"], *q["wqkv"], wb["bqkv"], *q["wo"], wb["bo"],
                 ln["ln_scale"], ln["ln_bias"], *q["w1"], wb["b1"], *q["w2"], wb["b2"])
        # the K-major copies a packed plan carries (models.fast_encode)
        kt = dict(wqkv_qt=FB.k_major(q["wqkv"][0]), wo_qt=FB.k_major(q["wo"][0]),
                  w1_qt=FB.k_major(q["w1"][0]), w2_qt=FB.k_major(q["w2"][0]))
        got = FB.fused_layer_q8(*qargs, **attn_kw, **kt)
        # s32 sums are exact in any order and the epilogue is one arithmetic:
        # the WMMA route (forced here) gives the same bits
        FB.force_wmma_gemm(True)
        try:
            old_route = FB.fused_layer_q8(*qargs, **attn_kw)
        finally:
            FB.force_wmma_gemm(False)
        torch.cuda.synchronize()
        assert torch.equal(got, old_route), f"B1{tag}: the wgmma route and the WMMA route differ"
        log(f"B1 fused_layer_q8{tag}: wgmma route == WMMA route bit for bit")
        want = FB.layer_q8_plain(*qargs, **attn_kw, n_chunks=n_chunks, eps=1e-5)
        cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1).min().item()
        log(f"B1 fused_layer_q8{tag}: min row cosine to plain {cos:.6f}")
        assert cos > 0.999, cos
        record(torch, results, f"B1 fused_layer_q8{tag}", SRC_FB, f"{REF_FB}:556", got, want, TOL_Q8_LAYER,
               lambda: FB.fused_layer_q8(*qargs, **attn_kw, **kt),
               lambda: FB.layer_q8_plain(*qargs, **attn_kw, n_chunks=n_chunks, eps=1e-5),
               bound_of=bounds["B1"], library_fn=lambda: lib["B1"](x))
        if split:
            kernel_split(torch, results, f"B1{tag or ' text'}", lambda: FB.fused_layer_q8(*qargs, **attn_kw, **kt),
                         {0: ("qkv", 6 * rows * width * width), 1: ("out-proj", 2 * rows * width * width),
                          3: ("c_fc", 2 * rows * width * ff), 4: ("c_proj", 2 * rows * width * ff)})
    torch.cuda.synchronize()
    wg, per_row = (after - before for after, before in zip(FB.attention_route_counts(), routes_before))
    assert wg > 0 and per_row == 0, f"attention interior routes at{tag or ' text'}: wgmma {wg}, one warp per row {per_row}"
    log(f"attention interior routes at{tag or ' text'}: wgmma {wg}, one warp per row {per_row}")


def _matmul_topk(torch, q, ci, ct, alpha, k):
    """The library yardstick for B2 exact: two ``matmul``s, the blend and
    ``topk``. Timed beside the kernel; the port never calls it."""
    a = alpha.reshape(-1, 1) if torch.is_tensor(alpha) else alpha
    return lambda: torch.topk(a * (q @ ci.T).float() + (1.0 - a) * (q @ ct.T).float(), k, dim=1)


def _matmul_topk_q8(torch, q, c8, alpha, k):
    """The yardstick for B2 q8, a sequence of PyTorch calls: the int8 rows
    cast to bf16, two ``matmul``s, the per-row scales, the blend, ``topk``."""
    iq, is_, tq, ts = c8
    a = alpha.reshape(-1, 1)

    def run():
        t2i, t2t = (q @ iq.to(q.dtype).T).float(), (q @ tq.to(q.dtype).T).float()
        return torch.topk(a * (t2i * is_.reshape(1, -1)) + (1.0 - a) * (t2t * ts.reshape(1, -1)), k, dim=1)

    return run


def _matmul_topk_q4(torch, q, c4, alpha, k):
    """The yardstick for B2-q4, a sequence of PyTorch calls: the nibbles
    unpacked and cast to bf16, one ``matmul`` per tower over the joined
    planes, the per-row scales, the blend, ``topk``."""
    ip, is_, tp, ts = c4
    a = alpha.reshape(-1, 1)

    def unpack(p):
        b = p.to(torch.int16)
        return torch.cat([((b & 0xF) ^ 8) - 8, b >> 4], dim=1).to(q.dtype)

    def run():
        t2i, t2t = (q @ unpack(ip).T).float(), (q @ unpack(tp).T).float()
        return torch.topk(a * (t2i * is_.reshape(1, -1)) + (1.0 - a) * (t2t * ts.reshape(1, -1)), k, dim=1)

    return run


def topk_edge_cases(torch, dev, rng, ci, ct, c8):
    """B2 at 1 and 3 queries and with text queries that differ from the image
    queries, exact and q8, against the plain versions (correctness only)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM

    norm = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    for qn in (1, 3, QUERIES):
        qi = _t(torch, dev, norm(rng.standard_normal((qn, WIDTH))), torch.bfloat16)
        qt = _t(torch, dev, norm(rng.standard_normal((qn, WIDTH))), torch.bfloat16)
        alpha = _t(torch, dev, rng.uniform(0.2, 0.8, qn), torch.float32)
        for q_txt in (None, qt):
            if q_txt is None and qn == QUERIES:
                continue  # the timed case
            got = SIM.fused_similarity_topk(qi, ci, ct, K, alpha=alpha, queries_txt=q_txt)
            topk_agree(got, SIM.blended_scores(qi, ci, ct, alpha, queries_txt=q_txt), K, TOL_TOPK)
            got = SIM.fused_similarity_topk_q8(qi, *c8, K, alpha=alpha, queries_txt=q_txt)
            topk_agree(got, SIM.blended_scores_q8(qi, *c8, alpha, queries_txt=q_txt), K, TOL_TOPK)
    torch.cuda.synchronize()
    log(f"B2 exact and q8 at Q = 1, 3 and with queries_txt != queries_img (Q = 1, 3, {QUERIES}): == plain top-k")


def kernel_phases(torch, dev, results):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM

    rng = np.random.default_rng(0)
    bf, f32 = torch.bfloat16, torch.float32

    def t(a, dtype):
        return _t(torch, dev, a, dtype)

    # B3a, B3b, B1 at ViT-L/14 text shapes
    layer_phases(torch, dev, results, rng, rows=ROWS, width=WIDTH, ff=FF,
                 attn_kw=dict(seq_len=SEQ, heads=HEADS, mask_len=SEQ, causal=True), tag="", split=True)

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
    record(torch, results, "B2 similarity_topk exact", src_sim, ref_sim, got[0], want[0], TOL_TOPK,
           lambda: SIM.fused_similarity_topk(qs, ci, ct, K, alpha=alpha),
           lambda: SIM.topk_plain(SIM.blended_scores(qs, ci, ct, alpha), K),
           bound_of=topk_bound(QUERIES, CORPUS, WIDTH, K, 2 * WIDTH), library_fn=_matmul_topk(torch, qs, ci, ct, alpha, K))
    iq, is_ = SIM.quantize_corpus_host(img)
    tq, ts = SIM.quantize_corpus_host(txt)
    c8 = (t(iq, torch.int8), t(is_, f32), t(tq, torch.int8), t(ts, f32))
    got = SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha)
    want = topk_agree(got, SIM.blended_scores_q8(qs, *c8, alpha), K, TOL_TOPK)
    record(torch, results, "B2 similarity_topk q8", src_sim, ref_sim, got[0], want[0], TOL_TOPK,
           lambda: SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha),
           lambda: SIM.topk_plain(SIM.blended_scores_q8(qs, *c8, alpha), K),
           bound_of=topk_bound(QUERIES, CORPUS, WIDTH, K, WIDTH + 4),
           library_fn=_matmul_topk_q8(torch, qs, c8, alpha, K))
    # the rerank tiers' default fetch (top_k 100 x rerank_factor 4), and a k that takes two passes
    for k in (400, 600):
        got = SIM.fused_similarity_topk_q8(qs, *c8, k, alpha=alpha)
        want = topk_agree(got, SIM.blended_scores_q8(qs, *c8, alpha), k, TOL_TOPK)
        record(torch, results, f"B2 similarity_topk q8 k={k}", src_sim, ref_sim, got[0], want[0], TOL_TOPK,
               lambda: SIM.fused_similarity_topk_q8(qs, *c8, k, alpha=alpha),
               lambda: SIM.topk_plain(SIM.blended_scores_q8(qs, *c8, alpha), k),
               bound_of=topk_bound(QUERIES, CORPUS, WIDTH, k, WIDTH + 4),
               library_fn=_matmul_topk_q8(torch, qs, c8, alpha, k))
    topk_edge_cases(torch, dev, rng, ci, ct, c8)
    torch.cuda.synchronize()


def vision_kernel_phases(torch, dev, results):
    """The corpus-precompute path's kernels at ViT-L/14 vision shapes."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import flash_attention as FA

    rng = np.random.default_rng(3)
    layer_phases(torch, dev, results, rng, rows=V_BATCH * V_SEQ, width=V_WIDTH, ff=V_FF,
                 attn_kw=dict(seq_len=V_SEQ, heads=V_HEADS, mask_len=V_MASK, causal=False),
                 tag=f" vision [{V_BATCH}x{V_SEQ}]", split=True)
    # ViT-L/14@336px: ten query tiles a (sequence, head), ten key tiles a pass
    layer_phases(torch, dev, results, rng, rows=4 * V336_SEQ, width=V_WIDTH, ff=V_FF,
                 attn_kw=dict(seq_len=V336_SEQ, heads=V_HEADS, mask_len=V336_MASK, causal=False),
                 tag=f" 336px [4x{V336_SEQ}]", layers=("B3a", "B1"), split=True)
    src = f"{PKG}/csrc/attention.cu"
    for name, shape, ref in (
        ("B6 flash_attention s=257", (64, 16, 257, 64), "knowledge_enhanced_multimodal_retrieval_tpu/ops/short_attention.py:85"),
        ("B7 flash_attention s=577", (16, 16, 577, 64), "knowledge_enhanced_multimodal_retrieval_tpu/ops/flash_attention.py:95"),
    ):
        q, k, v = (_t(torch, dev, rng.standard_normal(shape), torch.bfloat16) for _ in range(3))
        record(torch, results, name, src, ref, FA.flash_attention(q, k, v), FA.flash_attention_plain(q, k, v),
               TOL_ATTN, lambda: FA.flash_attention(q, k, v), lambda: FA.flash_attention_plain(q, k, v),
               bound_of=attention_bound(*shape),
               library_fn=lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
    # correctness only: the other head-dim instantiations and the causal mask
    for shape, causal in (((8, 4, 257, 32), False), ((8, 4, 577, 128), False), ((8, 4, 257, 64), True),
                          ((8, 4, 300, 128), True)):
        q, k, v = (_t(torch, dev, rng.standard_normal(shape), torch.bfloat16) for _ in range(3))
        got, want = FA.flash_attention(q, k, v, causal=causal), FA.flash_attention_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        log(f"B6/B7 flash_attention {list(shape)} causal={causal}: max_abs_err {err:.6g} (tolerance {TOL_ATTN:.6g})")
        if not np.isfinite(err) or err > TOL_ATTN:
            raise AssertionError(f"flash_attention {shape} causal={causal} disagrees with its plain version: {err}")
    torch.cuda.synchronize()


SRC_PV = f"{PKG}/scripts/profile_vision_interior.py + {SRC_FB}"
REF_PV = "scripts/profile_vision_interior.py"
S2_SETTINGS = {"gelu+requant": (True, True), "no requant": (True, False), "no gelu no requant": (False, False)}


def _q8_layer_plan(torch, dev, rng, width, ff):
    """One int8 layer as ``make_vision_plan`` packs it, from seeded weights:
    (LayerNorm 1, LayerNorm 2, the bf16 weights and f32 biases, the plan)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB

    ln, w, wb = _layer_weights(torch, dev, rng, width, ff)
    ln2 = _layer_weights(torch, dev, rng, width, ff)[0]
    lp = dict(ln1_scale=ln["ln_scale"], ln1_bias=ln["ln_bias"], ln2_scale=ln2["ln_scale"], ln2_bias=ln2["ln_bias"],
              **{k: wb[k] for k in ("bqkv", "bo", "b1", "b2")})
    for k in ("wqkv", "wo", "w1", "w2"):
        lp[k], lp[k + "_s"] = FB.quantize_weight(_t(torch, dev, w[k], torch.float32))
        lp[k + "_t"] = FB.k_major(lp[k])  # the K-major copy the int8 GEMM reads
    return ln, ln2, wb, lp


def block_q8_phases(torch, dev, results):
    """B4a, B4b, S1 and S2 against their plain versions at the profiler's
    shape, B4a and S1 also at ViT-L/14@336px's sequence; and the three bit
    equalities (pair == B1, S1 interior 0 == B4a, S2 gelu + requant == B4b)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_vision_interior as PV

    rng = np.random.default_rng(9)
    ln, ln2, wb, lp = _q8_layer_plan(torch, dev, rng, V_WIDTH, V_FF)
    a, m = PV.attn_operands(lp), PV.mlp_operands(lp)
    ak, mk = PV.attn_k_major(lp), PV.mlp_k_major(lp)
    n_chunks = FB.default_mlp_chunks(V_FF)
    q = {k: (lp[k], lp[k + "_s"]) for k in ("wqkv", "wo", "w1", "w2")}
    for nseq, seq, mask, tag in ((V_BATCH, V_SEQ, V_MASK, f" vision [{V_BATCH}x{V_SEQ}]"),
                                 (4, V336_SEQ, V336_MASK, f" 336px [4x{V336_SEQ}]")):
        x = _t(torch, dev, rng.standard_normal((nseq * seq, V_WIDTH)), torch.bfloat16)
        kw = dict(seq_len=seq, heads=V_HEADS, mask_len=mask, causal=False)
        bounds = layer_bounds(nseq * seq, V_WIDTH, V_FF, seq, mask, False)
        lib = layer_library(torch, ln, ln2, wb, q, **kw, n_chunks=n_chunks)
        y = FB.fused_attention_block_q8(x, *a, **kw, **ak)
        record(torch, results, f"B4a fused_attention_block_q8{tag}", SRC_FB, f"{REF_FB}:403", y,
               FB.attention_block_q8_plain(x, *a, **kw, eps=1e-5), TOL_Q8_LAYER,
               lambda: FB.fused_attention_block_q8(x, *a, **kw, **ak),
               lambda: FB.attention_block_q8_plain(x, *a, **kw, eps=1e-5), bound_of=bounds["B4a"],
               library_fn=lambda: lib["B4a"](x))
        for interior, label in ((PV.INTERIOR_PRODUCTION, "production"), (PV.INTERIOR_NOMAX, "no-max")):
            got = PV.attn_q8_variant(x, lp, interior=interior, **kw)
            record(torch, results, f"S1 attn_q8_variant {label}{tag}", SRC_PV, f"{REF_PV}:108", got,
                   PV.attn_q8_variant_plain(x, lp, interior=interior, **kw), TOL_Q8_LAYER,
                   lambda: PV.attn_q8_variant(x, lp, interior=interior, **kw),
                   lambda: PV.attn_q8_variant_plain(x, lp, interior=interior, **kw), bound_of=bounds["B4a"],
                   library_fn=lambda: lib["B4a"](x))
            if interior == PV.INTERIOR_PRODUCTION:
                assert torch.equal(got, y), f"S1 interior 0 differs from B4a{tag}"
        if seq != V_SEQ:
            whole = FB.fused_layer_q8(x, *a, *m, **kw, **ak, **mk)
            assert torch.equal(FB.fused_mlp_block_q8(y, *m, **mk), whole), f"B4b(B4a(x)) differs from B1(x) at{tag}"
            log(f"bit equalities at{tag}: B4b(B4a(x)) == B1(x), S1 interior 0 == B4a")
            continue
        out = FB.fused_mlp_block_q8(y, *m, **mk)
        record(torch, results, f"B4b fused_mlp_block_q8{tag}", SRC_FB, f"{REF_FB}:478", out,
               FB.mlp_block_q8_plain(y, *m, n_chunks=n_chunks, eps=1e-5), TOL_Q8_LAYER,
               lambda: FB.fused_mlp_block_q8(y, *m, **mk),
               lambda: FB.mlp_block_q8_plain(y, *m, n_chunks=n_chunks, eps=1e-5), bound_of=bounds["B4b"],
               library_fn=lambda: lib["B4b"](y))
        whole = FB.fused_layer_q8(x, *a, *m, **kw, **ak, **mk)
        torch.cuda.synchronize()
        assert torch.equal(out, whole), "B4b(B4a(x)) differs from B1(x)"
        for label, (gelu, requant) in S2_SETTINGS.items():
            got = PV.mlp_q8_diag(y, lp, gelu=gelu, requant=requant)
            record(torch, results, f"S2 mlp_q8_diag {label}{tag}", SRC_PV, f"{REF_PV}:177", got,
                   PV.mlp_q8_diag_plain(y, lp, gelu=gelu, requant=requant), TOL_Q8_LAYER,
                   lambda: PV.mlp_q8_diag(y, lp, gelu=gelu, requant=requant),
                   lambda: PV.mlp_q8_diag_plain(y, lp, gelu=gelu, requant=requant),
                   bound_of=bounds["B4b" if requant else "S2-bf16"],
                   library_fn=lambda: lib["S2"](y, gelu, requant))
            if gelu and requant:
                assert torch.equal(got, out), "S2 with gelu and requant differs from B4b"
        log(f"bit equalities at{tag}: B4b(B4a(x)) == B1(x), S1 interior 0 == B4a, S2 gelu+requant == B4b")
    torch.cuda.synchronize()


INTERIOR_SHAPES = (  # tag, sequences, seq_len, mask_len, heads, causal
    ("text", ROWS // SEQ, SEQ, SEQ, HEADS, True),
    (f"vision [{V_BATCH}x{V_SEQ}]", V_BATCH, V_SEQ, V_MASK, V_HEADS, False),
    (f"336px [4x{V336_SEQ}]", 4, V336_SEQ, V336_MASK, V_HEADS, False),
)


def interior_phase(torch, dev, results):
    """The layer kernels' attention interior alone on a fixed ``qkv``, both
    interiors, at the three full-width shapes: held to its plain version;
    device-only medians beside ``scaled_dot_product_attention`` on the same
    rows (a yardstick: other roundings, never called by the port), the bound
    and the one-warp-per-row route (forced), which these shapes took until
    the interior moved to the tensor cores. Then the routes by shape, and
    the bit equalities of the int8 halves at the text shape."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_vision_interior as PV

    rng = np.random.default_rng(14)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for tag, nseq, seq, mask, heads, causal in INTERIOR_SHAPES:
        width = heads * 64
        qkv = _t(torch, dev, rng.standard_normal((nseq * seq, 3 * width)), torch.bfloat16)
        q_, k_, v_ = qkv.view(nseq, seq, 3, heads, 64).permute(2, 0, 3, 1, 4)
        key_mask = (torch.arange(seq, device=dev) < mask).view(1, 1, 1, seq) if mask < seq else None
        kw = dict(seq_len=seq, heads=heads, mask_len=mask, causal=causal)
        bound_ms, bound_by = attention_bound(nseq, heads, seq, 64)
        lib_ms = device_ms(lambda: sdpa(q_, k_, v_, attn_mask=key_mask, is_causal=causal and key_mask is None))
        for sub_max, label in ((True, "production"), (False, "no-max")):
            before = FB.attention_route_counts()
            got = FB.attention_interior(qkv, subtract_max=sub_max, **kw)
            assert tuple(x - y for x, y in zip(FB.attention_route_counts(), before)) == (1, 0), f"interior {tag}: route"
            plain = lambda: FB._attention_interior(qkv, seq_len=seq, mask_len=mask, heads=heads, causal=causal,  # noqa: E731
                                                   out_dtype=torch.bfloat16, subtract_max=sub_max)
            torch.cuda.synchronize()
            err = float((got.float() - plain().float()).abs().max())
            if not np.isfinite(err) or err > TOL_INTERIOR:
                raise AssertionError(f"attention interior {label} {tag} disagrees with its plain version: {err}")
            ms = device_ms(lambda: FB.attention_interior(qkv, subtract_max=sub_max, **kw))
            plain_ms = device_ms(plain)
            FB.force_row_attention(True)
            try:
                before = FB.attention_route_counts()
                per_row = FB.attention_interior(qkv, subtract_max=sub_max, **kw)
                assert tuple(x - y for x, y in zip(FB.attention_route_counts(), before)) == (0, 1)
                per_row_ms = device_ms(lambda: FB.attention_interior(qkv, subtract_max=sub_max, **kw))
            finally:
                FB.force_row_attention(False)
            torch.cuda.synchronize()
            routes_err = float((got.float() - per_row.float()).abs().max())
            assert routes_err <= TOL_INTERIOR, f"interior {label} {tag}: the two routes differ by {routes_err}"
            log(f"attention interior {label} {tag}: max_abs_err {err:.6g} (tolerance {TOL_INTERIOR:.6g}; routes differ by "
                f"{routes_err:.6g}); device only: kernel {ms:.4f} ms, one warp per row {per_row_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({ms / bound_ms:.1f}x over it)")
            results.setdefault("interior", {})[f"{label} {tag}"] = dict(
                ms=ms, per_row_ms=per_row_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)

    # a head dim that is not 64 (width 100, two heads): the one-warp-per-row route, by shape alone
    width, heads, seq = 100, 2, 16
    x = _t(torch, dev, rng.standard_normal((9 * seq, width)), torch.bfloat16)
    ln, _, wb = _layer_weights(torch, dev, rng, width, 256)
    args = (x, ln["ln_scale"], ln["ln_bias"], wb["wqkv"], wb["bqkv"], wb["wo"], wb["bo"])
    kw = dict(seq_len=seq, heads=heads, mask_len=seq - 1, causal=False)
    before = FB.attention_route_counts()
    got = FB.fused_attention_block(*args, **kw)
    torch.cuda.synchronize()
    routes = tuple(a - b for a, b in zip(FB.attention_route_counts(), before))
    assert routes == (0, 1), f"width-100 B3a took routes {routes}"
    err = float((got.float() - FB.attention_block_plain(*args, **kw, eps=1e-5).float()).abs().max())
    assert err <= TOL_BF16_BLOCK, err
    log(f"attention interior routes at width 100 (head dim 50): wgmma 0, one warp per row 1; B3a max_abs_err {err:.6g}")

    # the int8 halves at the text shape: one interior behind B1, B4a and S1
    lp = _q8_layer_plan(torch, dev, rng, WIDTH, FF)[3]
    a, m = PV.attn_operands(lp), PV.mlp_operands(lp)
    ak, mk = PV.attn_k_major(lp), PV.mlp_k_major(lp)
    x = _t(torch, dev, rng.standard_normal((ROWS, WIDTH)), torch.bfloat16)
    kw = dict(seq_len=SEQ, heads=HEADS, mask_len=SEQ, causal=True)
    before = FB.attention_route_counts()
    y = FB.fused_attention_block_q8(x, *a, **kw, **ak)
    assert torch.equal(PV.attn_q8_variant(x, lp, interior=PV.INTERIOR_PRODUCTION, **kw), y), "S1 interior 0 differs from B4a at text"
    whole = FB.fused_layer_q8(x, *a, *m, **kw, **ak, **mk)
    assert torch.equal(FB.fused_mlp_block_q8(y, *m, **mk), whole), "B4b(B4a(x)) differs from B1(x) at text"
    err = float((y.float() - FB.attention_block_q8_plain(x, *a, **kw, eps=1e-5).float()).abs().max())
    assert err <= TOL_Q8_LAYER, err
    assert tuple(p - q for p, q in zip(FB.attention_route_counts(), before)) == (3, 0)
    torch.cuda.synchronize()
    log(f"bit equalities at text [{ROWS // SEQ}x{SEQ}]: B4b(B4a(x)) == B1(x), S1 interior 0 == B4a "
        f"(B4a max_abs_err {err:.6g}); all three on the wgmma route")


def topk_over_kernel_k_phase(torch, dev):
    """B2 (exact, q8, q4) and B5 asked for more rows than 128 (k = 160 and
    400): the kernels launch, once a pass, and agree with the plain top-k of
    the scores computed on the CPU (B5 bit for bit). k = 600 runs as two
    passes of 300 on a 5,000-row corpus: two launches each."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM

    rng = np.random.default_rng(15)
    qn = 32
    norm = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    qs = _t(torch, dev, norm(rng.standard_normal((qn, WIDTH))), torch.bfloat16)
    alpha = _t(torch, dev, rng.uniform(0.2, 0.8, qn), torch.float32)
    for n, ks in ((CORPUS, (160, 400)), (5000, (600,))):
        img, txt = norm(rng.standard_normal((n, WIDTH))), norm(rng.standard_normal((n, WIDTH)))
        ci, ct = _t(torch, dev, img, torch.bfloat16), _t(torch, dev, txt, torch.bfloat16)
        corpora = {"exact": ((ci, ct), SIM.fused_similarity_topk, SIM.blended_scores)}
        for mode, quant, fused, plain in (("q8", SIM.quantize_corpus_host, SIM.fused_similarity_topk_q8, SIM.blended_scores_q8),
                                          ("q4", SIM.quantize_corpus_host_q4, SIM.fused_similarity_topk_q4, SIM.blended_scores_q4)):
            (iq, is_), (tq, ts) = quant(img), quant(txt)
            c = (_t(torch, dev, iq, torch.int8), _t(torch, dev, is_, torch.float32),
                 _t(torch, dev, tq, torch.int8), _t(torch, dev, ts, torch.float32))
            corpora[mode] = (c, fused, plain)
        luts = [_t(torch, dev, 0.05 * rng.standard_normal((PQ_M, qn, PQ_K)), torch.bfloat16) for _ in range(2)]
        codes = [torch.tensor(rng.integers(0, PQ_K, (n, PQ_M)), dtype=torch.uint8, device=dev) for _ in range(2)]
        scales = [_t(torch, dev, rng.uniform(0.5, 1.5, (n, 1)), torch.float32) for _ in range(2)]
        pq_args = (alpha.reshape(-1, 1), luts[0], luts[1], codes[0], scales[0], codes[1], scales[1])
        for k in ks:
            passes = SIM.pass_sizes(k)[0]
            for mode, (c, fused, plain) in corpora.items():
                before = dispatch.launch_counts()["similarity_topk_kernel"]
                got = fused(qs, *c, k, alpha=alpha)
                assert dispatch.launch_counts()["similarity_topk_kernel"] == before + passes, f"B2 {mode} at k = {k}"
                assert tuple(got[0].shape) == (qn, k) and got[0].device == qs.device
                topk_agree(got, plain(qs.cpu(), *(t.cpu() for t in c), alpha.cpu()), k, TOL_TOPK)
            before = dispatch.launch_counts()["pq_adc_topk_kernel"]
            got = PQ.pq_adc_topk(*pq_args, k)
            assert dispatch.launch_counts()["pq_adc_topk_kernel"] == before + passes, f"B5 at k = {k}"
            want = SIM.topk_plain(PQ.blended_adc_from_luts(*(t.cpu() for t in pq_args)), k)
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]), f"B5 at k = {k}"
            log(f"k = {k} over {n} rows, Q = {qn}: B2 exact / q8 / q4 and B5 launched {passes} time(s) each "
                f"(passes of {SIM.pass_sizes(k)[1]}); == plain top-k on the CPU (B5 bit for bit)")
        del corpora, luts, codes, scales, pq_args
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


GEMM_EDGES = [(128, 128, 128), (1, 8, 16), (300, 200, 208), (130, 72, 48), (1000, 384, 384), (777, 512, 512),
              (2368, 1024, 1024), (64, 1000, 96)]


def gemm_edge_phase(torch, dev):
    """The layer kernels' GEMM alone (correctness only): ragged M, N and K,
    K = 384 and 512, every epilogue of both element types against the plain
    version (the accumulating epilogues over two chunks); every int8 result
    also bit for bit against the WMMA route."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB

    rng = np.random.default_rng(12)
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    worst = {False: 0.0, True: 0.0}
    before = FB.gemm_route_counts()
    for m, n, k in GEMM_EDGES:
        bias = _t(torch, dev, 0.1 * rng.standard_normal(n), f32)
        res = _t(torch, dev, rng.standard_normal((m, n)), bf)
        for int8 in (False, True):
            if int8:
                a, a2 = (torch.tensor(rng.integers(-127, 128, (m, k)), dtype=i8, device=dev) for _ in range(2))
                b, b2 = (torch.tensor(rng.integers(-127, 128, (k, n)), dtype=i8, device=dev) for _ in range(2))
                kw = dict(bias=bias, res=res, row_scale=_t(torch, dev, rng.uniform(1e-3, 2e-3, m), f32),
                          col_scale=_t(torch, dev, rng.uniform(1e-3, 2e-3, n), f32))
            else:
                a, a2 = (_t(torch, dev, rng.standard_normal((m, k)), bf) for _ in range(2))
                # products of O(1) whatever K is, so that results stay under 8 (bf16 step 2^-5)
                b, b2 = (_t(torch, dev, rng.standard_normal((k, n)) / np.sqrt(k), bf) for _ in range(2))
                kw = dict(bias=bias, res=res, col_scale=_t(torch, dev, rng.uniform(0.5, 1.5, n), f32))

            def run(epi):
                if epi in (FB.EPI_ACC_F32, FB.EPI_SCALE_ACC_F32):
                    return FB.gemm_epilogue(a2, b2, epi, acc=FB.gemm_epilogue(a, b, epi, last=False, **kw), last=True, **kw)
                return FB.gemm_epilogue(a, b, epi, **kw)

            for epi in (FB._EPI_INT8 if int8 else FB._EPI_BF16):
                got = run(epi)
                if epi in (FB.EPI_ACC_F32, FB.EPI_SCALE_ACC_F32):
                    want = FB.gemm_epilogue_plain(a2, b2, epi, acc=FB.gemm_epilogue_plain(a, b, epi, last=False, **kw),
                                                  last=True, **kw)
                else:
                    want = FB.gemm_epilogue_plain(a, b, epi, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                worst[int8] = max(worst[int8], err)
                if not np.isfinite(err) or err > TOL_BF16_BLOCK:
                    raise AssertionError(f"GEMM [{m}, {k}] x [{k}, {n}] int8={int8} epilogue "
                                         f"{GEMM_EPILOGUES[epi]!r} disagrees with its plain version: {err}")
                if int8:
                    FB.force_wmma_gemm(True)
                    try:
                        old = run(epi)
                    finally:
                        FB.force_wmma_gemm(False)
                    torch.cuda.synchronize()
                    assert torch.equal(got, old), f"GEMM [{m}, {k}] x [{k}, {n}] int8 {GEMM_EPILOGUES[epi]!r}: routes differ"
    wg, wmma = (x - y for x, y in zip(FB.gemm_route_counts(), before))
    assert wg > 0 and wmma > 0, (wg, wmma)
    log(f"GEMM edges {GEMM_EDGES}: every epilogue, max_abs_err bf16 {worst[False]:.6g}, int8 {worst[True]:.6g} "
        f"(tolerance {TOL_BF16_BLOCK:.6g}); int8 wgmma route == WMMA route bit for bit; launches wgmma {wg}, WMMA {wmma}")


def attention_routing_phase(torch, dev, results):
    """What ``ops.attention.mha``'s routing rests on: the attention kernel
    against ``mha_plain`` at the text tower's shapes and at short sequences
    (device-only medians), each held to the plain version; and that ``mha``
    launches the kernel at every one of them."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import flash_attention as FA
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.attention import mha, mha_plain

    rng = np.random.default_rng(13)
    lines = []
    for shape, causal in (((256, 12, 77, 64), True), ((256, 12, 16, 64), True), ((256, 12, 32, 64), True),
                          ((256, 12, 64, 64), True), ((256, 12, 128, 64), True), ((1, 12, 77, 64), True)):
        q, k, v = (_t(torch, dev, rng.standard_normal(shape), torch.bfloat16) for _ in range(3))
        before = FA.flash_attention_kernel.launches
        got = mha(q, k, v, causal=causal)
        assert FA.flash_attention_kernel.launches == before + 1, f"mha ran no kernel at {shape}"
        err = float((got.float() - mha_plain(q, k, v, causal=causal).float()).abs().max())
        if not np.isfinite(err) or err > 2 * TOL_ATTN:  # mha_plain rounds the normalized p: one more step
            raise AssertionError(f"mha {shape} disagrees with mha_plain: {err}")
        kern, plain = device_ms(lambda: mha(q, k, v, causal=causal)), device_ms(lambda: mha_plain(q, k, v, causal=causal))
        lines.append(f"{list(shape)} kernel {kern:.4f} ms, mha_plain {plain:.4f} ms")
        results.setdefault("mha_routing", {})[str(shape)] = dict(kernel_ms=kern, plain_ms=plain)
    log("attention kernel vs mha_plain, bf16 causal, device only: " + "; ".join(lines))


def profiler_phase(torch):
    """``scripts.profile_vision_interior.main`` at its defaults (full
    ViT-L/14 vision width); returns ({label: median ms}, launches)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_vision_interior as PV

    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    medians = PV.main([])
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert len(medians) == 7 and all(np.isfinite(v) and v > 0 for v in medians.values()), medians
    log(f"vision-interior profiler: {time.perf_counter() - t0:.1f} s (model build included); launches {counts}")
    torch.cuda.empty_cache()
    return medians, counts


def routing_phase(torch, dev, results):
    """A vision tower whose int8 layers exceed the routing cap (width 1536:
    12 x 1536^2 = 27 MiB a layer against 24 MiB) through ``make_vision_plan``
    and ``encode_image_fast``: B4a and B4b once per layer, B1 never. Depth is
    cut to 2 layers; the widths are whole. Returns the launches."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as FE
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import CLIPArch, build_model
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    arch = CLIPArch(embed_dim=768, image_resolution=224, vision_layers=2, vision_width=1536, vision_patch_size=14,
                    context_length=77, vocab_size=49408, text_width=512, text_heads=8, text_layers=1, vision_heads=24)
    model = build_model("", arch=arch, dtype=torch.bfloat16, seed=4, device=dev)
    plan = FE.make_vision_plan(model, quantize="int8")
    del model
    layer_bytes = FE._layer_weight_bytes(plan["layers"][0])
    assert layer_bytes > FE._LAYER_Q8_WIDE_CAP, (layer_bytes, FE._LAYER_Q8_WIDE_CAP)
    rng = np.random.default_rng(10)
    images = _t(torch, dev, rng.standard_normal((V_BATCH, 224, 224, 3)), torch.float32)
    with torch.no_grad():
        FE.encode_image_fast(arch, plan, images[:2])  # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        got = FE.encode_image_fast(arch, plan, images)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dispatch.launch_counts()
        n = arch.vision_layers
        assert (counts["fused_attention_block_q8"], counts["fused_mlp_block_q8"], counts["fused_layer_q8"]) == (n, n, 0), counts
        assert tuple(got.shape) == (V_BATCH, arch.embed_dim) and bool(torch.isfinite(got).all())
        # the same plan through the whole-layer route (the cap lifted for this one call): the same bits
        cap = FE._LAYER_Q8_WIDE_CAP
        FE._LAYER_Q8_WIDE_CAP = layer_bytes
        try:
            whole = FE.encode_image_fast(arch, plan, images)
        finally:
            FE._LAYER_Q8_WIDE_CAP = cap
        torch.cuda.synchronize()
        assert torch.equal(got, whole), "the per-block route differs from the whole-layer route"
        # and the plain versions on a CPU copy of the plan, for two images
        want = FE.encode_image_fast(arch, _cpu_plan(plan), images[:2].cpu())
    cos = torch.nn.functional.cosine_similarity(got[:2].cpu(), want, dim=-1).min().item()
    log(f"over-the-cap route: int8 layer {layer_bytes / 2**20:.1f} MiB > cap {cap / 2**20:.0f} MiB; batch {V_BATCH} in "
        f"{ms:.1f} ms (host clock around synchronize); launches {counts}; == whole-layer route; "
        f"min cosine to the plain versions (CPU, 2 images) {cos:.6f}")
    assert cos > 0.999, cos
    results["routing_batch_ms"] = ms
    torch.cuda.empty_cache()
    return counts


def _cpu_plan(plan):
    if isinstance(plan, dict):
        return {k: _cpu_plan(v) for k, v in plan.items()}
    if isinstance(plan, list):
        return [_cpu_plan(v) for v in plan]
    return plan.cpu()


def fake_t2s(*hits):
    """Text2SPARQL over a fake LLM and a fake KG: every query's hits are
    ``hits``, the uuids of the artefacts the fake KG holds."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.knowledge import (
        FakeKGSparqlClient,
        FakeLLMClient,
        Text2SparqlRetrieval,
    )

    llm_json = {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {"s": "DigitalArtefact", "p": "http://crm/P1", "o": "X_1",
                               "sType": ["http://kg/DigitalArtefact"]}}],
    }
    return Text2SparqlRetrieval(FakeLLMClient({}, default=json.dumps(llm_json)),
                                FakeKGSparqlClient(entities={}, artefacts=[f"http://kg/artefact/{u}" for u in hits]))


def serve_phase(torch, dev, model, store_path, mode, results):
    """Drive the served slice in one mode; returns {wrapper: launches}."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import encode_text_fast
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    tok = CLIPTokenizer(MERGES)
    store = EmbeddingStore.load(store_path)
    kw = dict(quantize="int8", quantize_corpus="int8") if mode == "int8" else dict(corpus_dtype=torch.bfloat16)
    retriever = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, **kw)
    engine = RetrievalEngine(retriever, fake_t2s(store.uuids[len(store) // 3]))
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

    # the same batches split: host tokenize, encode (ids to unit embeddings),
    # scan (B2), and what is left of retrieval_batch (rows to uuids, dicts)
    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    split = {"tokenize": [], "encode": [], "scan": [], "whole": []}
    for b in batches:
        t_tok, _ = clock(lambda: retriever._tokenize(b))
        t_enc, q_emb = clock(lambda: retriever.encode_queries(b))
        t_scan, _ = clock(lambda: retriever._score(retriever._corpus, q_emb, 0.5, K))
        t_all, _ = clock(lambda: retriever.retrieval_batch(b, alpha=0.5))
        for name, t in (("tokenize", t_tok), ("encode", t_enc - t_tok), ("scan", t_scan), ("whole", t_all)):
            split[name].append(t)
    med = {name: float(np.median(v)) for name, v in split.items()}
    med["uuid"] = med["whole"] - med["tokenize"] - med["encode"] - med["scan"]
    log(f"serve {mode}: batch split (medians of 3, host clock around synchronize): tokenize {med['tokenize']:.2f} ms, "
        f"encode {med['encode']:.2f} ms, scan {med['scan']:.2f} ms, uuid mapping and the rest {med['uuid']:.2f} ms "
        f"of a {med['whole']:.2f} ms retrieval_batch")
    results[f"serve_{mode}_split_ms"] = med

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
    del engine, retriever
    torch.cuda.empty_cache()
    return counts


def _check_store(store, n_docs, tag):
    assert store.uuids == [f"uuid-{i:06d}" for i in range(n_docs)], f"{tag}: uuid order"
    for rows in (store.image, store.text):
        assert rows.shape == (n_docs, WIDTH) and np.isfinite(rows).all(), f"{tag}: rows"
        np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-3, err_msg=tag)


def _agree(stores, ref, tag):
    """Row-by-row agreement of each encoder's store with ``ref``'s."""
    for enc, st in stores.items():
        if enc == ref:
            continue
        cos = min(float(np.sum(st.image * stores[ref].image, axis=1).min()),
                  float(np.sum(st.text * stores[ref].text, axis=1).min()))
        log(f"{tag}: {enc} store vs {ref} store, min row cosine {cos:.6f} (bound {STORE_COS})")
        assert cos > STORE_COS, (tag, enc, cos)


def precompute_phase(torch, tmp, model_name, n_docs, image_size, encoder):
    """Drive ``cli.precompute.main`` once; returns (store, launches, seconds)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import precompute
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    tag = f"precompute {model_name} {encoder}"
    out = os.path.join(tmp, f"{image_size}_{encoder}.npz")
    args = [f"--model.name={model_name}", f"--data.dataset=synthetic:{n_docs}", f"--data.image_size={image_size}",
            "--eval.batch_size=256", f"--eval.encoder={encoder}", f"--out={out}", "--device=cuda"]
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    precompute.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    store = EmbeddingStore.load(out)
    _check_store(store, n_docs, tag)
    log(f"{tag}: {n_docs} rows in {secs:.2f} s end to end (model build included; host clock); launches {counts}")
    return store, counts, secs


def precompute_stages(torch, dev, model, encoder, results):
    """Where a precompute run spends its time, on the model already built:
    ``build_embedding_store`` over synthetic:300 (images/s), and one
    256-image batch split into host preprocess + tokenize, vision tower and
    the two text encodes (medians of 3 after a warm-up, host clock around
    work that ends in a synchronize)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import (
        encode_image_fast,
        encode_text_fast,
        make_encode_plans,
    )
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import build_embedding_store

    pipe = DataPipeline(make_synthetic_source(N_DOCS, image_size=224), CLIPTokenizer([]), image_size=224)
    use_fast, quantize = encoder != "flax", ("int8" if encoder == "int8" else None)

    def clock(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3

    store_ms = clock(lambda: build_embedding_store(model, pipe, 256, use_fast=use_fast, quantize=quantize), reps=1)
    host_ms = clock(lambda: pipe.make_batch(range(256)))
    b = pipe.make_batch(range(256))
    images = torch.as_tensor(b.images, device=dev)
    q_ids = torch.as_tensor(b.query_ids, dtype=torch.long, device=dev)
    t_ids = torch.as_tensor(b.target_ids, dtype=torch.long, device=dev)
    arch = model.arch
    with torch.no_grad():
        if use_fast:
            plans = make_encode_plans(model, dtype=model.dtype, quantize=quantize)
            img_fn = lambda: encode_image_fast(arch, plans["visual"], images)  # noqa: E731
            txt_fn = lambda: (encode_text_fast(arch, plans["text"], q_ids), encode_text_fast(arch, plans["text"], t_ids))  # noqa: E731
        else:
            img_fn = lambda: model.encode_image(images)  # noqa: E731
            txt_fn = lambda: (model.encode_text(q_ids), model.encode_text(t_ids))  # noqa: E731
        img_ms, txt_ms = clock(img_fn), clock(txt_fn)
    rate = N_DOCS / (store_ms / 1e3)
    log(f"precompute {encoder}: build_embedding_store {N_DOCS} rows {store_ms:.1f} ms ({rate:.1f} images/s); "
        f"one 256 batch: host preprocess+tokenize {host_ms:.1f} ms, vision tower {img_ms:.1f} ms, "
        f"text query+target {txt_ms:.1f} ms")
    results[f"precompute_{encoder}"] = dict(images_per_s=rate, store_ms=store_ms, host_ms=host_ms,
                                            vision_ms=img_ms, text_ms=txt_ms)


def fast_vision_vs_cpu(torch, dev, model):
    """The fast vision encoder on the card against its plain versions on a
    CPU copy of the plan, for two images."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.preprocess import preprocess_pil
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import encode_image_fast, make_vision_plan

    src = make_synthetic_source(2, image_size=224, seed=11)
    px = torch.tensor(np.stack([preprocess_pil(src[i]["image"]) for i in range(2)]))
    plan = make_vision_plan(model, dtype=torch.bfloat16)
    with torch.no_grad():
        got = encode_image_fast(model.arch, plan, px.to(dev)).cpu()
        want = encode_image_fast(model.arch, _cpu_plan(plan), px)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item()
    log(f"fast vision encoder on the card vs plain versions (CPU): min cosine {cos:.6f}")
    assert cos > 0.999, cos


def image_query_phase(torch, dev, model, store_path, docs, results):
    """64 image queries at alpha = 1 over the 43,000-row store with the
    precomputed rows appended; returns the launches of the run."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    store = EmbeddingStore.load(store_path).with_added(docs.image, docs.text, [f"doc-{u}" for u in docs.uuids])
    retriever = CLIPRetrieval(model, CLIPTokenizer(MERGES), store, device=dev, top_k=K,
                              use_fused_encoder=True, corpus_dtype=torch.bfloat16)
    engine = RetrievalEngine(retriever)
    src = make_synthetic_source(N_DOCS, image_size=224)
    images = [src[i]["image"] for i in range(IMAGE_QUERIES)]
    engine.retrieve_image_batch(images[:8], alpha_clip=1.0)  # first call: builds the vision plan
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.retrieve_image_batch(images, alpha_clip=1.0)
    torch.cuda.synchronize()
    lat = time.perf_counter() - t0
    counts = dispatch.launch_counts()
    worst = 1.0
    for i, r in enumerate(out):
        scores = [x["score"] for x in r]
        assert len(r) == K and all(np.isfinite(scores)) and scores == sorted(scores, reverse=True)
        assert r[0]["uuid"] == f"doc-uuid-{i:06d}", (i, r[:3])
        worst = min(worst, r[0]["score"])
    assert worst >= 1 - TOL_SELF, worst
    log(f"image queries: {IMAGE_QUERIES} in {lat * 1e3:.1f} ms over {len(store)} rows (host clock); "
        f"each found its own row first, min score {worst:.5f}; launches {counts}")
    results["image_query_batch_ms"] = lat * 1e3

    c = retriever._corpus
    q = retriever.encode_images(retriever.preprocess_images(images)).to(torch.bfloat16).contiguous()
    got = retriever._score(c, q, 1.0, K)
    want = topk_agree(got, SIM.blended_scores(q, c.corpus_img, c.corpus_txt, 1.0), K, TOL_TOPK)
    record(torch, results, "B2 similarity_topk exact, image queries", f"{PKG}/csrc/similarity.cu",
           "knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py:680", got[0], want[0], TOL_TOPK,
           lambda: SIM.fused_similarity_topk(q, c.corpus_img, c.corpus_txt, K, alpha=1.0),
           lambda: SIM.topk_plain(SIM.blended_scores(q, c.corpus_img, c.corpus_txt, 1.0), K),
           bound_of=topk_bound(IMAGE_QUERIES, len(store), WIDTH, K, 2 * WIDTH),
           library_fn=_matmul_topk(torch, q, c.corpus_img, c.corpus_txt, 1.0, K))
    del engine, retriever
    torch.cuda.empty_cache()
    return counts


def _onehot_adc_topk(torch, args, k, chunk=None):
    """The library yardstick for B5: the JAX package's ADC formulation
    (``blended_scores_pq_adc``), per tower one bf16 product of the LUT
    ``[Q, M * K]`` with the one-hot codes ``[M * K, N]``, then the per-row
    scales, the blend and ``topk``. With ``chunk`` None the one-hots are
    built here, outside the timed call; otherwise the call builds them
    ``chunk`` rows at a time. The port never calls it."""
    alpha, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t = args
    m, qn, n_k = lut_i.shape
    luts = [lut.permute(1, 0, 2).reshape(qn, m * n_k) for lut in (lut_i, lut_t)]
    offs = (torch.arange(m, device=lut_i.device) * n_k)[None, :]

    def onehot(codes):
        oh = torch.zeros((codes.shape[0], m * n_k), dtype=torch.bfloat16, device=codes.device)
        return oh.scatter_(1, codes.long() + offs, 1.0)

    def tower(lut, codes, scale, oh=None):
        if oh is not None:
            return (lut @ oh.T).float() * scale.reshape(1, -1)
        return torch.cat([(lut @ onehot(codes[lo:lo + chunk]).T).float() for lo in range(0, codes.shape[0], chunk)],
                         dim=1) * scale.reshape(1, -1)

    ohs = [onehot(codes_i), onehot(codes_t)] if chunk is None else [None, None]

    def run():
        t2i = tower(luts[0], codes_i, scale_i, ohs[0])
        t2t = tower(luts[1], codes_t, scale_t, ohs[1])
        return torch.topk(alpha * t2i + (1.0 - alpha) * t2t, k, dim=1)

    return run


def capacity_kernel_phases(torch, dev, results):
    """B2-q4 and B5 against their plain versions at the served corpus size
    and at the scale ladder's 1M rows (random packed bytes and codes)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM

    rng = np.random.default_rng(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    norm = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)  # noqa: E731
    qs = _t(torch, dev, norm(rng.standard_normal((QUERIES, WIDTH))), bf)
    alpha = _t(torch, dev, rng.uniform(0.2, 0.8, (QUERIES, 1)), f32)
    src_sim, src_pq = f"{PKG}/csrc/similarity.cu", f"{PKG}/csrc/pq.cu"
    ref_q4 = "knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py:619"
    ref_pq = "knowledge_enhanced_multimodal_retrieval_tpu/ops/pq.py:708"
    for n in (CORPUS, SCALE_ROWS):
        t0 = time.perf_counter()
        plain_iters = 20 if n == CORPUS else 3  # the plain B5 at 1M rows takes ~1.9 s a call
        if n == CORPUS:  # host-packed real rows
            packs = [SIM.quantize_corpus_host_q4(norm(rng.standard_normal((n, WIDTH)))) for _ in range(2)]
            c4 = (_t(torch, dev, packs[0][0], torch.int8), _t(torch, dev, packs[0][1], f32),
                  _t(torch, dev, packs[1][0], torch.int8), _t(torch, dev, packs[1][1], f32))
        else:  # random nibbles: the kernel does not care, and host packing would cost minutes
            rand_bytes = lambda: torch.randint(0, 256, (n, WIDTH // 2), dtype=torch.uint8, device=dev, generator=gen).view(torch.int8)  # noqa: E731
            rand_scale = lambda: 0.01 + 0.02 * torch.rand((n, 1), device=dev, generator=gen)  # noqa: E731
            c4 = (rand_bytes(), rand_scale(), rand_bytes(), rand_scale())
        got = SIM.fused_similarity_topk_q4(qs, *c4, K, alpha=alpha)
        want = topk_agree(got, SIM.blended_scores_q4(qs, *c4, alpha), K, TOL_TOPK)
        record(torch, results, f"B2-q4 similarity_topk q4 [{n}]", src_sim, ref_q4, got[0], want[0], TOL_TOPK,
               lambda: SIM.fused_similarity_topk_q4(qs, *c4, K, alpha=alpha),
               lambda: SIM.topk_plain(SIM.blended_scores_q4(qs, *c4, alpha), K), plain_iters,
               bound_of=topk_bound(QUERIES, n, WIDTH, K, WIDTH // 2 + 4),
               library_fn=_matmul_topk_q4(torch, qs, c4, alpha, K))
        del c4

        luts = [(0.05 * torch.randn((PQ_M, QUERIES, PQ_K), device=dev, generator=gen)).to(bf) for _ in range(2)]
        codes = [torch.randint(0, PQ_K, (n, PQ_M), dtype=torch.uint8, device=dev, generator=gen) for _ in range(2)]
        scales = [0.5 + torch.rand((n, 1), device=dev, generator=gen) for _ in range(2)]
        for sc in scales:
            sc[-100:] = 0.0  # capacity-pad rows score exactly 0
        args = (alpha, luts[0], luts[1], codes[0], scales[0], codes[1], scales[1])
        for k in (K, 128, 400) if n == CORPUS else (K,):
            got = PQ.pq_adc_topk(*args, k)
            want = topk_agree(got, PQ.blended_adc_from_luts(*args), k, TOL_TOPK)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"B5 at {n} rows, k = {k}: not bit-equal"
            library = _onehot_adc_topk(torch, args, k, chunk=None if n == CORPUS else 65536)
            record(torch, results, f"B5 pq_adc_topk [{n}]" + ("" if k == K else f" k={k}"), src_pq, ref_pq, got[0],
                   want[0], 0.0, lambda: PQ.pq_adc_topk(*args, k),
                   lambda: SIM.topk_plain(PQ.blended_adc_from_luts(*args), k), plain_iters,
                   bound_of=pq_bound(QUERIES, n, PQ_M, PQ_K, k), library_fn=library)
            del library
            torch.cuda.empty_cache()
        del args, luts, codes, scales
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"capacity kernels at {n} rows: {time.perf_counter() - t0:.1f} s")


def _ids_agree(got_v, got_i, want_v, want_i, tol, tag):
    """Two top-k lists agree: values within ``tol``, and wherever the rows
    differ, the two values are a near tie."""
    np.testing.assert_allclose(got_v, want_v, rtol=tol, atol=tol, err_msg=tag)
    diff = got_i != want_i
    assert (np.abs(got_v - want_v)[diff] <= tol).all(), tag
    return float(diff.mean())


def capacity_serve_phase(torch, dev, model, store_path, tier, kw, results):
    """Serve one compressed-corpus tier through ``CLIPRetrieval`` +
    ``RetrievalEngine``; returns {wrapper: launches} of the batches."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import binary_sketch as BS
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.ann import ivf_search
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    t_phase = time.perf_counter()
    store = EmbeddingStore.load(store_path)
    t0 = time.perf_counter()
    retriever = CLIPRetrieval(model, CLIPTokenizer(MERGES), store, device=dev, top_k=K, use_fused_encoder=True, **kw)
    build_s = time.perf_counter() - t0
    engine = RetrievalEngine(retriever)
    rng = np.random.default_rng(6)
    words = ["cat", "hel", "hello", "ca", "he"]
    batches = [[" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)] for _ in range(4)]
    engine.retrieve_text_noknowledge_batch(batches[3])  # warm-up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    lat = []
    for b in batches[:3]:
        t0 = time.perf_counter()
        out = engine.retrieve_text_noknowledge_batch(b, alpha_clip=list(rng.uniform(0.2, 0.8, len(b))))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        for r in out:
            scores = [x["score"] for x in r]
            assert len(r) == K and all(np.isfinite(scores)) and scores == sorted(scores, reverse=True), tier
            assert all(x["uuid"].startswith("uuid-") for x in r), tier
    counts = dispatch.launch_counts()

    # the served top-k against the plain top-k on the same query embeddings
    c = retriever._corpus
    q = retriever.encode_queries(batches[1]).float()
    a = 0.5
    fetch = retriever._k_fetch(c, K)
    got = retriever._score(c, q, a, fetch)
    if "ivf" in tier:
        sub = q[:32]
        got = retriever._score(c, sub, a, fetch)
        cpu = ivf_search(sub.cpu(), c.ivf.to("cpu"), k=fetch, nprobe=c.nprobe, alpha=a)
        tol = TOL_IVF_PQ if kw["quantize_corpus"] == "pq" else TOL_IVF
        swapped = _ids_agree(got[0].cpu().numpy(), got[1].cpu().numpy(), cpu[0].numpy(), cpu[1].numpy(), tol, tier)
        check = f"probe on the card == probe on the CPU (rows swapped at near ties: {swapped:.4f})"
    else:
        qt = SIM.prefix_normalize(q, retriever.truncate_dim) if retriever.truncate_dim else q
        qr = qt @ retriever._rot if retriever._rot is not None else qt
        qm = qr.to(model.dtype)
        if kw["quantize_corpus"] == "int4":
            scores = SIM.blended_scores_q4(qm, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, a)
        elif kw["quantize_corpus"] == "int8":
            scores = SIM.blended_scores_q8(qm, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, a)
        elif kw["quantize_corpus"] == "pq":
            (ci, cbi), (ct, cbt) = c.corpus_img, c.corpus_txt
            # the card serves B5's ADC scores (the CPU the decode path)
            plain = PQ.blended_scores_pq_adc if qm.is_cuda else PQ.blended_scores_pq
            scores = plain(qm, ci, c.corpus_img_scale, ct, c.corpus_txt_scale, cbi, cbt, a)
        else:  # binary: the Hamming proxies, on a CPU copy
            dim = c.store.dim
            qb = BS.pack_sign_bits(qr.cpu())
            prox = [1.0 - torch.tensor(2.0 / dim) * BS.hamming_scores(qb, w.cpu()).float()
                    for w in (c.corpus_img, c.corpus_txt)]
            scores = a * prox[0] + (1.0 - a) * prox[1]
        topk_agree(got, scores, fetch, TOL_TOPK)
        check = "served top-k == plain top-k"
    if retriever.rerank:
        # reranked scores are the exact host rescore of the fetched rows
        qn = q.cpu().numpy()
        res = retriever.retrieval_embeddings_batch(q, alpha=a)
        row = {u: i for i, u in enumerate(c.store.uuids)}
        for qi, r in enumerate(res):
            rows = np.array([row[x["uuid"]] for x in r])
            exact = a * (c.store.image[rows] @ qn[qi]) + (1.0 - a) * (c.store.text[rows] @ qn[qi])
            np.testing.assert_allclose([x["score"] for x in r], exact, rtol=1e-6, atol=1e-7, err_msg=tier)
        check += "; reranked scores == exact host rescore"

    # recall@10 against the exact blended ranking of the f32 store, for the
    # text queries (random-weight encoder: they sit off the corpus, so their
    # true top-10 margins are thin) and for 256 corpus text rows as queries
    # (the calibrate_nprobe default: queries on the corpus distribution)
    img = torch.as_tensor(store.image, device=dev)
    txt = torch.as_tensor(store.text, device=dev)

    def recall_at_10(qq):
        res = retriever.retrieval_embeddings_batch(qq, alpha=a, top_k=10)
        exact_ids = torch.topk(a * (qq @ img.T) + (1.0 - a) * (qq @ txt.T), 10, dim=1).indices.cpu().numpy()
        return float(np.mean([len({store.uuids[i] for i in e} & {x["uuid"] for x in r}) / 10.0
                              for e, r in zip(exact_ids, res)]))

    recall = recall_at_10(q)
    # the rows the quality sweep script samples as queries at its --seed 0
    rows_q = np.random.default_rng(0).choice(CORPUS, QUERIES, replace=False)
    recall_rows = recall_at_10(txt[torch.as_tensor(rows_q, device=dev)])
    med = float(np.median(lat) * 1e3)
    secs = time.perf_counter() - t_phase
    log(f"serve {tier}: build {build_s:.1f} s; 256-query batch median {med:.2f} ms; recall@10 {recall:.4f} "
        f"(corpus rows as queries {recall_rows:.4f}); {check}; launches {counts}; phase {secs:.1f} s")
    results.setdefault("capacity_tiers", {})[tier] = dict(
        batch_ms=med, recall_at_10=recall, recall_at_10_corpus_rows=recall_rows, build_s=build_s)
    if tier in ("pq", "binary+rotate+rerank"):
        # the packed arrays the sharded serving phase scans again (no second k-means)
        results.setdefault("packed", {})[tier] = (c.corpus_img, c.corpus_txt, c.corpus_img_scale,
                                                  c.corpus_txt_scale, retriever._rot, q)
    del engine, retriever, img, txt
    torch.cuda.empty_cache()
    return counts


def rerank_default_topk_phase(torch, dev, model, store_path):
    """The int8 + truncate_dim 256 + rerank tier at the retriever's default
    top_k = 100: the rerank over-fetches 4x, so B2 selects 400 rows (and the
    capacity pad) a query. One 256-query batch after a warm-up; the fetch
    against the plain top-k on the same query embeddings. Returns the
    batch's launches."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    retriever = CLIPRetrieval(model, CLIPTokenizer(MERGES), EmbeddingStore.load(store_path), device=dev,
                              use_fused_encoder=True, quantize_corpus="int8", truncate_dim=256, rerank=True)
    engine = RetrievalEngine(retriever)
    rng = np.random.default_rng(9)
    words = ["cat", "hel", "hello", "ca", "he"]
    batches = [[" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)] for _ in range(2)]
    engine.retrieve_text_noknowledge_batch(batches[0])  # warm-up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.retrieve_text_noknowledge_batch(batches[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = dispatch.launch_counts()
    top_k = retriever.top_k
    for r in out:
        scores = [x["score"] for x in r]
        assert len(r) == top_k and all(np.isfinite(scores)) and scores == sorted(scores, reverse=True)
    assert counts["similarity_topk_kernel"] > 0, "the rerank tier at top_k = 100 never launched B2"
    c = retriever._corpus
    q = retriever.encode_queries(batches[1]).float()
    fetch = retriever._k_fetch(c, top_k)
    assert fetch > 128, fetch
    got = retriever._score(c, q, 0.5, fetch)
    qm = SIM.prefix_normalize(q, retriever.truncate_dim).to(model.dtype)
    topk_agree(got, SIM.blended_scores_q8(qm, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, 0.5),
               fetch, TOL_TOPK)
    log(f"serve int8+truncate256+rerank at the default top_k = {top_k} (fetch {fetch}): 256-query batch {ms:.2f} ms; "
        f"launches {counts}; fetched top-k == plain top-k")
    del engine, retriever
    torch.cuda.empty_cache()
    return counts


def capacity_phases(torch, dev, model, tmp, results):
    """The compressed-corpus tiers over a clustered 43,000-row store; the
    IVF tiers serve caches written by ``cli.index``."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import index as index_cli
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    rng = np.random.default_rng(8)
    centers = rng.standard_normal((1000, WIDTH)).astype(np.float32)
    pick = rng.integers(0, 1000, CORPUS)

    def tower():
        x = centers[pick] + 0.6 * rng.standard_normal((CORPUS, WIDTH)).astype(np.float32)
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    path = os.path.join(tmp, "clustered.npz")
    EmbeddingStore(image=tower(), text=tower(), uuids=[f"uuid-{i:06d}" for i in range(CORPUS)]).save(path)
    counts = {}
    for tier, kw in CAPACITY_TIERS.items():
        kw = dict(kw)
        if kw.get("ann"):
            out = os.path.join(tmp, f"ivf_{kw['quantize_corpus']}.npz")
            t0 = time.perf_counter()
            index_cli.main(["--store", path, "--out", out, f"--eval.quantize_corpus={kw['quantize_corpus']}",
                            "--device=cuda"])
            torch.cuda.synchronize()
            log(f"cli.index {kw['quantize_corpus']}: {time.perf_counter() - t0:.1f} s")
            stamp = os.stat(out).st_mtime_ns
            # the pq lists' default budget refuses 256-query batches at nprobe 8
            kw |= dict(ann_nprobe=NPROBE, ann_index_path=out, ann_max_batch_lookups=0)
        counts[tier] = capacity_serve_phase(torch, dev, model, path, tier, kw, results)
        if kw.get("ann"):
            assert os.stat(out).st_mtime_ns == stamp, f"{tier} rebuilt its index instead of loading cli.index's"
    counts["rerank top_k=100"] = rerank_default_topk_phase(torch, dev, model, path)
    assert counts["int4"]["similarity_topk_kernel"] > 0, "B2-q4 never launched while serving int4"
    for tier in ("pq", "pq+opq"):
        assert counts[tier]["pq_adc_topk_kernel"] > 0, f"B5 never launched while serving {tier}"
    return counts


SHARDS = 4  # the sharded serving phase's mesh: [cuda:0] * 4
SHARD_NLIST = 208  # sharded IVF: sqrt(43,000) = 207 snapped to a multiple of the shards
TOL_QDP = 1e-3  # shard_queries against the whole batch: the int8 rules (ROADMAP "Hazards"), in score units


def _served_agree(got, want, tol, tag):
    """Served result lists agree: scores within ``tol`` (relative and
    absolute), uuids equal wherever the two scores are no near tie (2 tol)."""
    assert len(got) == len(want), tag
    ties = 0
    for a, b in zip(got, want):
        assert len(a) == len(b), tag
        np.testing.assert_allclose([x["score"] for x in a], [x["score"] for x in b], rtol=tol, atol=tol, err_msg=tag)
        for x, y in zip(a, b):
            if x["uuid"] != y["uuid"]:
                assert abs(x["score"] - y["score"]) <= 2 * tol, (tag, x, y)
                ties += 1
    return ties


def _multihost_cli_phase(torch, dev, tmp, store_path, model, queries):
    """Two ``cli.serve --multihost`` processes over gloo, both on the card
    (NCCL refuses two ranks on one device): the int8 corpus sharded over
    the two, rank 0 answering the queries from standard input. Returns the
    coordinator's answers, the processes' logs and the wall seconds."""
    import gzip

    bpe = os.path.join(tmp, "bpe.txt.gz")
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    qfile = os.path.join(tmp, "mh_queries.txt")
    with open(qfile, "w") as f:
        f.write("\n".join(queries) + "\n")
    port = free_port()
    cmd = [sys.executable, "-m", f"{PKG}.cli.serve", "--store", store_path, "--model.name=ViT-L/14",
           "--eval.encoder=int8", "--eval.quantize_corpus=int8", "--eval.shard_corpus=true", "--multihost",
           "--multihost-batch=8", "--batch", f"--device={dev.type}"]
    procs, logs, outs = [], [], []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       CLIP_BPE_PATH=bpe, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID"):
                env.pop(var, None)
            # output to files, not pipes: the two are coupled by collectives
            out, err = (open(os.path.join(tmp, f"mh{rank}.{x}"), "w+") for x in ("out", "err"))
            logs.append((out, err))
            with open(qfile) as stdin:
                procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdin=stdin, stdout=out, stderr=err,
                                              text=True))
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:  # never leave a collective-blocked process behind
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    wall = time.perf_counter() - t0
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"cli.serve --multihost exited {p.returncode}:\n{err[-3000:]}"
    answers, dec, text, i = [], json.JSONDecoder(), outs[0][0], 0
    while True:
        i = text.find("{", i)
        if i < 0:
            break
        obj, i = dec.raw_decode(text, i)
        answers.append(obj)
    assert [a["query"] for a in answers] == queries, "the coordinator did not answer every query"
    assert "runtime_init: torch.distributed gloo" in outs[0][1] and "gloo" in outs[1][1], "gloo did not run"
    return answers, wall


def sharded_serving_phase(torch, dev, tmp, model, store_path, clustered_path, results):
    """Sharded serving over ``[cuda:0] * 4`` (ROADMAP A5 (a)): returns
    {path: {wrapper: launches}}. See item 24 of the module docstring."""
    import torch.distributed as dist

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import binary_sketch as BS
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime, RowShards
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import ann as ANN
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.multihost import MultiHostSearch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    t_phase = time.perf_counter()
    costs, counts, report = {}, {}, {}
    rt = MeshRuntime.create(MeshConfig(data_parallel=SHARDS), [dev] * SHARDS)
    mesh = rt.mesh
    tok = CLIPTokenizer(MERGES)
    store = EmbeddingStore.load(store_path)
    rng = np.random.default_rng(12)
    words = ["cat", "hel", "hello", "ca", "he"]
    batch = [" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)]
    alphas = list(rng.uniform(0.2, 0.8, QUERIES))
    allow = [store.uuids[i] for i in range(0, len(store), 5)]
    sim, b1, b3a, b3b = "similarity_topk_kernel", "fused_layer_q8", "fused_attention_block", "fused_mlp_block"

    # shard_corpus, the flat tiers: rows in 4 views of one staged copy, B2 once a shard
    t0 = time.perf_counter()
    tiers = {"exact": dict(corpus_dtype=torch.bfloat16), "int8": dict(quantize="int8", quantize_corpus="int8"),
             "int4": dict(quantize_corpus="int4")}
    for tier, kw in tiers.items():
        plain = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, **kw)
        sharded = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, rt=rt,
                                shard_corpus=True, **kw)
        assert isinstance(sharded.corpus_img, RowShards) and sharded.corpus_img.shard_n == CORPUS // SHARDS
        base = sharded.corpus_img.shards[0][1]
        assert all(t.data_ptr() == base.data_ptr() + g * base[0].numel() * base.element_size() * (CORPUS // SHARDS)
                   for g, t in sharded.corpus_img.shards), f"{tier}: a shard is not a row view"
        sharded.retrieval_batch(batch[:8])  # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t1 = time.perf_counter()
        got = sharded.retrieval_batch(batch, alpha=alphas)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        c = dispatch.launch_counts()
        counts[f"shard_corpus {tier}"] = c
        assert c[sim] == SHARDS, f"{tier}: B2 launched {c[sim]} times for {SHARDS} shards"
        q = plain.encode_queries(batch).float()
        ties = _served_agree(sharded.retrieval_embeddings_batch(q, alpha=alphas),
                             plain.retrieval_embeddings_batch(q, alpha=alphas), TOL_TOPK, f"shard_corpus {tier}")
        _served_agree(got, plain.retrieval_batch(batch, alpha=alphas), TOL_TOPK, f"shard_corpus {tier} text")
        f_got = sharded.retrieval_filtered_batch(batch[:64], allow_uuids=allow)
        _served_agree(f_got, plain.retrieval_filtered_batch(batch[:64], allow_uuids=allow), TOL_TOPK,
                      f"shard_corpus {tier} filtered")
        assert all(x["uuid"] in set(allow) for r in f_got for x in r)
        cands = [store.uuids[50 * i:50 * i + 50] for i in range(len(batch[:64]))]
        _served_agree(sharded.retrieval_candidates_batch(batch[:64], cands),
                      plain.retrieval_candidates_batch(batch[:64], cands), 1e-6, f"shard_corpus {tier} candidates")
        report[f"shard_corpus {tier}"] = dict(batch_ms=ms, near_tie_swaps=ties)
        log(f"sharded serving, shard_corpus {tier}: 256-query batch {ms:.2f} ms; launches {c}; served == unsharded "
            f"({ties} near-tie swaps), filtered and candidate batches too")
        del plain, sharded
    costs["shard_corpus tiers"] = time.perf_counter() - t0

    # pq and binary: the sharded functions on the arrays the capacity tiers packed
    t0 = time.perf_counter()
    packed = results.pop("packed")
    (ci, cbi), (ct, cbt), si, st, _, q = packed["pq"]
    qm = q.to(model.dtype).contiguous()
    dispatch.reset_launch_counts()
    got = PQ.sharded_pq_similarity_topk(qm, ci, si, ct, st, cbi, cbt, K, 0.5, mesh)
    counts["sharded pq"] = dispatch.launch_counts()
    assert counts["sharded pq"]["pq_adc_topk_kernel"] == SHARDS
    want = PQ.pq_similarity_topk(qm, ci, si, ct, st, cbi, cbt, K, 0.5)
    assert torch.equal(got[0], want[0]), "sharded pq values differ from the one-shard call"
    _ids_agree(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].cpu().numpy(), want[1].cpu().numpy(), 0.0,
               "sharded pq")
    wi, wt, _, _, rot, qb = packed["binary+rotate+rerank"]
    qr = qb.float() @ rot
    got = BS.sharded_hamming_topk(qr, wi, wt, dim=WIDTH, k=4 * K, alpha=0.5, mesh=mesh)
    want = BS.hamming_topk(qr, wi, wt, dim=WIDTH, k=4 * K, alpha=0.5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), "sharded binary != one-shard binary"
    costs["pq + binary"] = time.perf_counter() - t0
    log("sharded serving: pq (B5 once a shard) and binary == the one-shard calls on the capacity tiers' arrays")

    # sharded IVF int8 over the clustered store, nlist snapped to 208
    t0 = time.perf_counter()
    cstore = EmbeddingStore.load(clustered_path)
    ivf = CLIPRetrieval(model, tok, cstore, device=dev, top_k=K, use_fused_encoder=True, quantize_corpus="int8",
                        ann="ivf", ann_nlist=207, ann_nprobe=NPROBE, rt=rt, shard_corpus=True)
    c = ivf._corpus
    assert c.ivf.nlist == SHARD_NLIST and len(c.ivf_shards.shards) == SHARDS
    qf = q[:64].float()
    full = ANN.sharded_ivf_search(qf, c.ivf_shards, k=K, nprobe=SHARD_NLIST, mesh=mesh, alpha=0.5)
    (iq, isc), (tq, tsc) = SIM.quantize_corpus_host(cstore.image), SIM.quantize_corpus_host(cstore.text)
    exact = SIM.blended_scores_q8(qf, *(torch.from_numpy(a).to(dev) for a in (iq, isc, tq, tsc)), 0.5)
    topk_agree(full, exact, K, TOL_IVF)
    got = ANN.sharded_ivf_search(qf, c.ivf_shards, k=K, nprobe=NPROBE, mesh=mesh, alpha=0.5)
    cpu_rt = MeshRuntime.create(MeshConfig(data_parallel=SHARDS), [torch.device("cpu")] * SHARDS)
    want = ANN.sharded_ivf_search(qf.cpu(), c.ivf.to("cpu"), k=K, nprobe=NPROBE, mesh=cpu_rt.mesh, alpha=0.5)
    swapped = _ids_agree(got[0].cpu().numpy(), got[1].cpu().numpy(), want[0].numpy(), want[1].numpy(), TOL_IVF,
                         "sharded ivf")
    res = ivf.retrieval_batch(batch[:64])
    assert all(len(r) == K for r in res)
    del ivf
    costs["sharded ivf"] = time.perf_counter() - t0
    log(f"sharded serving: IVF int8 nlist {SHARD_NLIST} in {SHARDS} shards: nprobe = nlist == the exact int8 scan; "
        f"nprobe {NPROBE} on the card == on the CPU (rows swapped at near ties {swapped:.4f}); {costs['sharded ivf']:.1f} s")

    # shard_queries: the batch splits four ways, each slice encoded and scanned on its device
    t0 = time.perf_counter()
    for enc, kw in (("int8", dict(quantize="int8", quantize_corpus="int8")), ("fast", dict(corpus_dtype=torch.bfloat16))):
        plain = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, **kw)
        qdp = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, rt=rt,
                            shard_queries=True, **kw)
        qdp.retrieval_batch(batch[:8])  # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t1 = time.perf_counter()
        got = qdp.retrieval_batch(batch, alpha=alphas)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        c = dispatch.launch_counts()
        counts[f"shard_queries {enc}"] = c
        layers = model.arch.text_layers
        if enc == "int8":
            assert c[b1] == layers * SHARDS and c[sim] == SHARDS, f"shard_queries int8 launches {c}"
        else:
            assert c[b3a] == c[b3b] == layers * SHARDS and c[sim] == SHARDS, f"shard_queries fast launches {c}"
        ties = _served_agree(got, plain.retrieval_batch(batch, alpha=alphas), TOL_QDP, f"shard_queries {enc}")
        report[f"shard_queries {enc}"] = dict(batch_ms=ms, near_tie_swaps=ties)
        log(f"sharded serving, shard_queries {enc}: 256-query batch in {SHARDS} slices {ms:.2f} ms; launches {c}; "
            f"== the whole batch ({ties} near-tie swaps)")
        del plain, qdp
    costs["shard_queries"] = time.perf_counter() - t0

    # B2 q8 at 1,000,000 rows in 4 shards against the one-shard scan
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    rand8 = lambda: torch.randint(-127, 128, (SCALE_ROWS, WIDTH), dtype=torch.int8, device=dev, generator=gen)  # noqa: E731
    rands = lambda: 0.005 + 0.01 * torch.rand((SCALE_ROWS, 1), device=dev, generator=gen)  # noqa: E731
    c8 = (rand8(), rands(), rand8(), rands())
    qs = _t(torch, dev, q.float().cpu().numpy(), torch.bfloat16)
    alpha = _t(torch, dev, rng.uniform(0.2, 0.8, (QUERIES, 1)), torch.float32)
    one = SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha)
    dispatch.reset_launch_counts()
    got = SIM.sharded_similarity_topk_q8(qs, *c8, K, alpha, mesh)
    launches_1m = dispatch.launch_counts()[sim]
    assert launches_1m == SHARDS
    # both the sharded and the one-shard winners held to the plain top-k of the plain scores
    scores = SIM.blended_scores_q8(qs, *c8, alpha)
    want = topk_agree(got, scores, K, TOL_TOPK)
    topk_agree(one, scores, K, TOL_TOPK)
    del scores
    _ids_agree(got[0].cpu().numpy(), got[1].cpu().numpy(), one[0].cpu().numpy(), one[1].cpu().numpy(), TOL_TOPK,
               "B2 q8 1M in 4 shards")
    name = f"B2 similarity_topk q8 [{SCALE_ROWS}] {SHARDS} shards"
    record(torch, results, name, f"{PKG}/csrc/similarity.cu + {PKG}/ops/similarity.py (sharded_similarity_topk_q8)",
           "knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py:764", got[0], want[0], TOL_TOPK,
           lambda: SIM.sharded_similarity_topk_q8(qs, *c8, K, alpha, mesh),
           lambda: SIM.topk_plain(SIM.blended_scores_q8(qs, *c8, alpha), K), 5,
           bound_of=topk_bound(QUERIES, SCALE_ROWS, WIDTH, K, WIDTH + 4),
           library_fn=_matmul_topk_q8(torch, qs, c8, alpha, K))
    one_ms = median_ms(lambda: SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha))
    one_dev = device_ms(lambda: SIM.fused_similarity_topk_q8(qs, *c8, K, alpha=alpha))
    report["b2_q8_1m"] = dict(sharded_ms=results[name]["ms"], sharded_device_ms=results[name]["device_ms"],
                              one_shard_ms=one_ms, one_shard_device_ms=one_dev)
    del c8
    torch.cuda.empty_cache()
    costs["B2 q8 1M"] = time.perf_counter() - t0
    log(f"sharded serving: B2 q8 at {SCALE_ROWS:,} rows in {SHARDS} shards {results[name]['ms']:.3f} / "
        f"{results[name]['device_ms']:.3f} ms (events / device), one shard {one_ms:.3f} / {one_dev:.3f} ms")

    # multi-host: two cli.serve --multihost processes over gloo on the one card,
    # then a world-size-1 NCCL group driving MultiHostSearch in this process
    t0 = time.perf_counter()
    mh_queries = batch[:16]
    single = RetrievalEngine(CLIPRetrieval(model, tok, store, device=dev, use_fused_encoder=True, quantize="int8",
                                           quantize_corpus="int8"))
    want = single.retrieve_text_noknowledge_batch(mh_queries)
    answers, mh_wall = _multihost_cli_phase(torch, dev, tmp, store_path, model, mh_queries)
    mh_ties = _served_agree([a["results"] for a in answers], [w[:20] for w in want], TOL_TOPK, "multihost gloo")
    costs["multihost gloo (2 processes)"] = mh_wall
    t1 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        assert dist.get_backend() == backend
        rt2 = MeshRuntime.create(MeshConfig(data_parallel=2), [dev] * 2)
        sharded = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, quantize="int8",
                                quantize_corpus="int8", rt=rt2, shard_corpus=True)
        mh = MultiHostSearch(sharded, batch=64)
        dispatch.reset_launch_counts()
        got = mh.search_texts(batch[:128], alpha=0.5)
        counts["multihost nccl"] = dispatch.launch_counts()
        mh.stop()
        assert counts["multihost nccl"][sim] == 2 * 2  # two work items, two shards each
        ref = CLIPRetrieval(model, tok, store, device=dev, top_k=K, use_fused_encoder=True, quantize="int8",
                            quantize_corpus="int8")
        nccl_ties = _served_agree(got, ref.retrieval_batch(batch[:128], alpha=0.5), TOL_TOPK, "multihost nccl")
        del sharded, ref
    finally:
        dist.destroy_process_group()
    costs["multihost nccl (world 1)"] = time.perf_counter() - t1
    log(f"sharded serving, multi-host: 2 cli.serve --multihost processes over gloo on one card == the single "
        f"retriever ({len(answers)} queries, {mh_ties} near-tie swaps; {mh_wall:.1f} s); world-size-1 NCCL "
        f"MultiHostSearch == the single retriever ({nccl_ties} near-tie swaps)")
    costs["multihost"] = time.perf_counter() - t0
    secs = time.perf_counter() - t_phase
    results["sharded_serving"] = dict(report, costs_s=costs, phase_s=secs)
    log(f"sharded serving phase {secs:.1f} s: " + ", ".join(f"{k} {v:.1f}" for k, v in costs.items()))
    counts["b2_q8_1m"] = {sim: launches_1m}
    return counts


def free_port() -> int:
    """A free local TCP port for a rendezvous."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


DAEMON_CLIENTS, DAEMON_REQUESTS, DAEMON_IMAGE_FRAC = 32, 20, 0.1  # scripts/daemon_bench.py's mix
DAEMON_WARMUP = "1,2,4,8,16,32,64,128,256"
# fused answers: the engine rounds alpha * clip + beta * hit to 4 decimals,
# so one rounding step beside the top-k tolerance
TOL_FUSED = 1e-4 + TOL_TOPK


def _png_blobs(rng, n, size):
    import base64
    import io

    from PIL import Image

    blobs = []
    for _ in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8), "RGB").save(buf, format="PNG")
        blobs.append(base64.b64encode(buf.getvalue()).decode())
    return blobs


def _http(base, method, path, body=None):
    """One request; a status other than 200 raises, with the server's answer."""
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    data = None if body is None else json.dumps(body).encode()
    req = Request(base + path, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urlopen(req, timeout=300) as r:
            if r.status != 200:
                raise AssertionError(f"{method} {path}: HTTP {r.status}")
            raw = r.read()
    except HTTPError as e:
        raise AssertionError(f"{method} {path}: HTTP {e.code} {e.read()[:300]!r}") from None
    return raw.decode() if path == "/metrics" else json.loads(raw)


def _same_lists(got, want, tol, tag):
    """One query's result lists: the same uuids up to near ties (a swap only
    between scores within ``tol``, or at the last place), scores within ``tol``."""
    assert len(got) == len(want), (tag, len(got), len(want))
    np.testing.assert_allclose([x["score"] for x in got], [x["score"] for x in want], atol=tol, rtol=0, err_msg=tag)
    sg, sw = {x["uuid"]: x["score"] for x in got}, {x["uuid"]: x["score"] for x in want}
    if want:
        last = min(got[-1]["score"], want[-1]["score"])
        for u in sg.keys() ^ sw.keys():
            assert abs(sg.get(u, sw.get(u)) - last) <= 2 * tol, (tag, u)


def _padded_rows(hist, cap):
    return sum(min(1 << (n - 1).bit_length(), cap) * c for n, c in hist.items())


def daemon_phase(torch, dev, tmp, store_path, results):
    """The HTTP daemon on the card, built by ``cli.serve``'s own wiring
    (``pop_daemon_flags``, ``build_engine``, ``warm_engine``,
    ``make_http_server``) at ViT-L/14 over the 43,000-row store, with the
    Text2SPARQL fakes: 32 client threads x 20 requests (about 10 % image
    queries), then filtered, candidate, document, snapshot, health and
    metrics requests one at a time, each held to the engine called directly;
    then a short pass with the ``fast`` encoder and an exact corpus. Returns
    {pass: {wrapper: launches}}."""
    import gzip
    import logging
    import shutil
    import threading

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve as S
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.knowledge import text2sparql  # noqa: F401 (its logger)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

    t_phase = time.perf_counter()
    # Text2SPARQL logs every query it answers: hundreds of lines under this traffic
    t2s_log = logging.getLogger("kemr_torch.text2sparql")
    t2s_level = t2s_log.level
    t2s_log.setLevel(logging.WARNING)
    vocab = os.path.join(tmp, "bpe_simple.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    os.environ["CLIP_BPE_PATH"] = vocab  # cli.serve's tokenizer: the synthetic BPE table
    daemon_store = os.path.join(tmp, "daemon_store.npz")  # /snapshot writes here
    shutil.copyfile(store_path, daemon_store)
    rng = np.random.default_rng(5)
    words = ["cat", "hel", "hello", "ca", "he"]
    queries = [" ".join(rng.choice(words, size=rng.integers(2, 14))) for _ in range(256)]
    blobs = _png_blobs(rng, 8, 224)
    counts = {}

    def start(extra):
        args = ["--model.name=ViT-L/14", "--http=0", "--http-host=127.0.0.1",
                "--max-pending=4096", "--cache-results=1024", f"--warmup={DAEMON_WARMUP}", "--bucket-queries"] + extra
        opts = S.pop_daemon_flags(args)
        cfg = config_from_argv(args)
        t0 = time.perf_counter()
        engine = S.build_engine(cfg, daemon_store, dev)
        engine.t2s_retriever = fake_t2s(*(f"uuid-{i:06d}" for i in (7, 4242, 31000)))
        t_build = time.perf_counter() - t0
        n_warm, t_warm = S.warm_engine(engine, cfg, opts.warmup, image=True)
        server = S.make_http_server(engine, cfg, daemon_store, opts).start()
        log(f"daemon {extra}: engine built in {t_build:.1f} s; warmup {n_warm} searches in {t_warm:.1f} s; "
            f"listening on {server.address[0]}:{server.address[1]}")
        return cfg, engine, server, "http://{}:{}".format(*server.address), (n_warm, t_warm)

    def expected_fused(engine, cfg, clip_lists, n):
        hits = engine.t2s_retriever.retrieval("any")
        return [engine._apply_threshold(engine._fuse_clip_sparql_linear(c, hits, alpha=cfg.fusion.alpha,
                                                                         beta=cfg.fusion.beta),
                                        cfg.fusion.threshold)[:n] for c in clip_lists]

    # -- the int8 daemon under concurrent traffic ------------------------------
    cfg, engine, server, base, warm = start(["--eval.encoder=int8", "--eval.quantize_corpus=int8"])
    retriever = engine.clip_retriever
    assert _http(base, "GET", "/healthz")["ok"]
    torch.cuda.synchronize()
    lat, answers, errors = {"text": [], "image": []}, [], []
    lock = threading.Lock()
    barrier = threading.Barrier(DAEMON_CLIENTS + 1)

    def client(cid):
        crng = np.random.default_rng(100 + cid)
        barrier.wait()
        for _ in range(DAEMON_REQUESTS):
            is_img = crng.random() < DAEMON_IMAGE_FRAC
            t0 = time.perf_counter()
            try:
                if is_img:
                    out = _http(base, "POST", "/search_image", {"image": blobs[int(crng.integers(len(blobs)))]})
                    assert 0 < len(out["results"]) <= 20 and all(np.isfinite(x["score"]) for x in out["results"])
                else:
                    q = queries[int(crng.integers(len(queries)))]
                    alpha = None if crng.random() < 0.5 else float(crng.uniform(0.2, 0.8))
                    body = {"query": q, "n": 20} | ({} if alpha is None else {"alpha": alpha})
                    out = _http(base, "POST", "/search", body)
                dt = time.perf_counter() - t0
                with lock:
                    lat["image" if is_img else "text"].append(dt)
                    if not is_img:
                        answers.append((q, cfg.fusion.alpha_clip if alpha is None else alpha, out["results"]))
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(DAEMON_CLIENTS)]
    for t in threads:
        t.start()
    dispatch.reset_launch_counts()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["int8"] = dispatch.launch_counts()
    if errors:
        raise AssertionError(f"{len(errors)} daemon requests failed: {errors[:3]}")
    text_stats, image_stats = server.batcher.stats, server.image_batcher.stats
    total = len(lat["text"]) + len(lat["image"])
    # repeated (query, alpha) pairs come from the result cache, not the batcher
    assert total == DAEMON_CLIENTS * DAEMON_REQUESTS and 0 < text_stats["served"] <= len(lat["text"])

    def pct(v):
        v = sorted(v)
        return {p: v[min(len(v) - 1, int(q * len(v)))] * 1e3 for p, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))}

    arch = retriever.model.arch
    want_b1 = arch.text_layers * text_stats["batches"] + arch.vision_layers * image_stats["batches"]
    got = counts["int8"]
    log(f"daemon int8: launches {got}; B1 {got['fused_layer_q8']} = {arch.text_layers} text layers x "
        f"{text_stats['batches']} text batches + {arch.vision_layers} vision layers x {image_stats['batches']} image batches "
        f"({want_b1}); B2 q8 {got['similarity_topk_kernel']} (batches {text_stats['batches'] + image_stats['batches']})")
    assert got["fused_layer_q8"] == want_b1 > 0, "B1 did not launch once a layer for each text and image batch"
    assert got["similarity_topk_kernel"] == text_stats["batches"] + image_stats["batches"] > 0
    assert image_stats["batches"] > 0 and text_stats["batches"] > 0
    real = {m: sum(n * c for n, c in st["batch_size_hist"].items()) for m, st in (("text", text_stats),
                                                                                 ("image", image_stats))}
    padded = {"text": _padded_rows(text_stats["batch_size_hist"], 256),
              "image": _padded_rows(image_stats["batch_size_hist"], 64)}
    summary = dict(
        requests=total, wall_s=wall, qps=total / wall, text_ms=pct(lat["text"]), image_ms=pct(lat["image"]),
        batcher_text_ms=text_stats["latency_ms"], batcher_image_ms=image_stats["latency_ms"],
        text_hist=text_stats["batch_size_hist"], image_hist=image_stats["batch_size_hist"],
        real_rows=real, padded_rows=padded, warmup_searches=warm[0], warmup_s=warm[1],
        cache_hits=len(lat["text"]) - text_stats["served"],
    )
    log(f"daemon int8: {total} requests from {DAEMON_CLIENTS} clients in {wall:.3f} s = {total / wall:.1f} q/s; "
        f"text end to end p50/p95/p99 {summary['text_ms']['p50']:.2f} / {summary['text_ms']['p95']:.2f} / "
        f"{summary['text_ms']['p99']:.2f} ms, image {summary['image_ms']['p50']:.2f} / {summary['image_ms']['p95']:.2f}"
        f" / {summary['image_ms']['p99']:.2f} ms (host clock, client threads)")
    log(f"daemon int8: MicroBatcher submit-to-result text {text_stats['latency_ms']}, image {image_stats['latency_ms']}; "
        f"{summary['cache_hits']} text requests answered from the result cache")
    log(f"daemon int8: batch sizes text {text_stats['batch_size_hist']}, image {image_stats['batch_size_hist']}; "
        f"rows real / padded to a power of two: text {real['text']} / {padded['text']}, "
        f"image {real['image']} / {padded['image']}")

    # every /search answer against the engine called directly, per seq bucket
    # and alpha as the daemon batched them (--bucket-queries)
    groups = {}
    for q, a, res in answers:
        groups.setdefault(retriever.seq_bucket(q), []).append((q, a, res))
    for bucket, items in groups.items():
        direct = retriever.retrieval_batch([q for q, _, _ in items], alpha=[a for _, a, _ in items])
        for (q, a, res), want in zip(items, expected_fused(engine, cfg, direct, 20)):
            _same_lists(res, want, TOL_FUSED, f"/search {q!r} alpha {a}")
    # the daemon's split: one text batch of the median size, called directly
    sizes = [n for n, c in text_stats["batch_size_hist"].items() for _ in range(c)]
    med_batch = int(np.median(sizes))
    b = queries[:med_batch]
    batch_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.retrieve_text_batch(b + [b[-1]] * (_padded_rows({med_batch: 1}, 256) - med_batch),
                                   alpha_clip=[0.5] * _padded_rows({med_batch: 1}, 256))
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    summary["median_batch"], summary["batch_ms"] = med_batch, float(np.median(batch_ms))
    log(f"daemon int8: split of a text request: end to end p50 {summary['text_ms']['p50']:.2f} ms, of which the "
        f"MicroBatcher (queue + batch) p50 {text_stats['latency_ms']['p50']:.2f} ms and one padded batch of the "
        f"median size {med_batch} {summary['batch_ms']:.2f} ms (engine called directly, median of 5); the rest is "
        f"HTTP, JSON and threads")

    # filtered, candidate and document requests, one at a time
    allow = [f"uuid-{i:06d}" for i in range(0, CORPUS, 97)]
    deny = [f"uuid-{i:06d}" for i in range(0, CORPUS, 2)]
    c = retriever._corpus
    cpu = [t.cpu() for t in (c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale)]
    for q, al, de in ((queries[0], allow, None), (queries[1], None, deny), (queries[2], allow, deny[:500])):
        out = _http(base, "POST", "/search", {"query": q, "n": 20}
                    | ({"allow_uuids": al} if al else {}) | ({"deny_uuids": de} if de else {}))["results"]
        mask = retriever._mask_from_uuids(c, al, de)
        q_emb = retriever.encode_queries([q]).to(torch.bfloat16).cpu()
        vals, idx = SIM.masked_similarity_topk_q8(q_emb, *cpu, mask, k=retriever.top_k, alpha=cfg.fusion.alpha_clip)
        plain = retriever.results_from_topk(vals.numpy(), idx.numpy(), _state=c, top_k=retriever.top_k)
        _same_lists(out, expected_fused(engine, cfg, plain, 20)[0], TOL_FUSED, f"filtered {q!r}")
        assert out and all(al is None or x["uuid"] in al for x in out)
        assert not any(x["uuid"] in (de or ()) for x in out)
    cands = [allow[:40], deny[100:130] + ["uuid-none"]]
    out = _http(base, "POST", "/search", {"queries": queries[3:5], "candidates": cands, "alpha": 0.3, "n": 10})
    q_emb = retriever.encode_queries(queries[3:5]).float().cpu().numpy()
    row = {u: i for i, u in enumerate(c.store.uuids)}
    for qi, (res, cand) in enumerate(zip(out["results"], cands)):
        exact = sorted(((0.3 * float(c.store.image[row[u]] @ q_emb[qi]) + 0.7 * float(c.store.text[row[u]] @ q_emb[qi]), u)
                        for u in cand if u in row), reverse=True)[:10]
        _same_lists(res, [{"uuid": u, "score": s} for s, u in exact], TOL_TOPK, f"candidates {qi}")
    # a document whose rows are a query's own embedding ranks first
    probe = queries[5]
    e = retriever.encode_queries([probe]).float().cpu().numpy()[0].tolist()
    added = _http(base, "POST", "/documents", {"documents": [{"uuid": "daemon-doc", "image_embedding": e,
                                                             "text_embedding": e}]})
    # a raw document: the daemon encodes it (B1 on the vision and text towers)
    added_raw = _http(base, "POST", "/documents", {"documents": [{"uuid": "daemon-raw", "image": blobs[0],
                                                                 "text": "hello cat"}]})
    assert added == added_raw == {"added": 1}, (added, added_raw)
    out = _http(base, "POST", "/search", {"query": probe, "n": 5})["results"]
    assert out[0]["uuid"] == "daemon-doc", out[:2]
    assert _http(base, "DELETE", "/documents", {"uuids": ["daemon-doc"]}) == {"removed": 1}
    assert all(x["uuid"] != "daemon-doc" for x in _http(base, "POST", "/search", {"query": probe, "n": 20})["results"])
    snap = _http(base, "POST", "/snapshot", {})
    assert snap["rows"] == CORPUS + 1 and len(EmbeddingStore.load(daemon_store)) == CORPUS + 1, snap
    health = _http(base, "GET", "/healthz")
    assert health["ok"] and health["stats"]["served"] >= text_stats["served"]
    metrics = _http(base, "GET", "/metrics")
    assert 'kemr_requests_served_total{modality="image"}' in metrics
    server.close()
    log(f"daemon int8: {len(answers)} /search answers == engine.retrieve_text_batch (retrieval_batch + fusion) "
        f"within {TOL_FUSED:g}; filtered == plain masked top-k; candidates == exact host scores; "
        f"documents added, found, removed; snapshot {snap['rows']} rows")
    del engine, retriever, server, cpu
    torch.cuda.empty_cache()

    # -- the fast encoder and the exact corpus, briefly ---------------------------
    shutil.copyfile(store_path, daemon_store)
    cfg, engine, server, base, _ = start(["--eval.encoder=fast"])
    dispatch.reset_launch_counts()
    outs = [_http(base, "POST", "/search", {"query": q, "n": 20}) for q in queries[10:18]]
    torch.cuda.synchronize()
    counts["fast"] = dispatch.launch_counts()
    direct = engine.clip_retriever.retrieval_batch(queries[10:18], alpha=cfg.fusion.alpha_clip)
    for q, out, want in zip(queries[10:18], outs, expected_fused(engine, cfg, direct, 20)):
        _same_lists(out["results"], want, TOL_FUSED, f"fast /search {q!r}")
    server.close()
    log(f"daemon fast: launches {counts['fast']}")
    for name in ("fused_attention_block", "fused_mlp_block", "similarity_topk_kernel"):
        assert counts["fast"][name] > 0, f"{name} never launched behind the fast daemon"
    del engine, server
    torch.cuda.empty_cache()
    t2s_log.setLevel(t2s_level)
    summary["phase_s"] = time.perf_counter() - t_phase
    results["daemon"] = summary
    log(f"daemon phase: {summary['phase_s']:.1f} s")
    return counts


# -- evaluation, learned fusion and the quality sweep --------------------------

EVAL_N = 1024  # synthetic examples each cli.evaluate run encodes (4 batches of 256)
SWEEP_CPU_ROWS, SWEEP_BLOCK = 4096, 1024  # the sweep held to the CPU; stripe rows
NEAR_TIE = 1e-5  # a row whose diagonal and a competitor lie this close may rank either way
FUSION_N, HEAD_EPOCHS = 512, 2  # cli.train_fusion's synthetic split; epochs of the five other heads
FUSED_CLIENTS, FUSED_REQUESTS = 8, 8
# a head on the card against the same head on the CPU (f32, TF32 off)
TOL_HEAD_CARD = dict(rtol=1e-4, atol=1e-5)
# the same head over the same candidates (tests/test_fused_serving.py:45)
TOL_HEAD = dict(rtol=2e-5, atol=1e-6)
TOL_RECALL = 0.002  # quality sweep rows against the served tiers' recall@10


class _Spy:
    """Wrap callables (``(owner, name)`` pairs, module or class attributes)
    while a phase runs, and keep each call's wall seconds (the card synced
    before and after), its kernel launches and its result; restored on exit."""

    def __init__(self, torch, targets):
        from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

        self.torch, self.dispatch, self.targets = torch, dispatch, targets
        self.calls = {name: [] for _, name in targets}
        self.saved = []

    def _wrap(self, name, fn):
        def spy(*a, **kw):
            self.torch.cuda.synchronize()
            before = self.dispatch.launch_counts()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            after = self.dispatch.launch_counts()
            self.calls[name].append(dict(seconds=time.perf_counter() - t0, result=out,
                                         launches={k: after[k] - before[k] for k in after}))
            return out

        return spy

    def __enter__(self):
        for owner, name in self.targets:
            fn = owner.__dict__[name]
            self.saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        return False

    def launches(self, name, kernel):
        return [c["launches"][kernel] for c in self.calls[name]]


def _near_tie_rows(torch, sim):
    """Rows of a square score matrix whose diagonal lies within ``NEAR_TIE``
    of another entry (their rank may differ with the summation order)."""
    gap = (sim - torch.diagonal(sim)[:, None]).abs()
    gap.fill_diagonal_(float("inf"))
    return (gap.min(dim=1).values <= NEAR_TIE).cpu().numpy()


def _ranks_agree(torch, got, want, near, tag):
    got, want = np.asarray(got), np.asarray(want)
    bad = (got != want) & ~near
    assert not bad.any(), f"{tag}: {int(bad.sum())} rows rank differently on the card, e.g. {np.flatnonzero(bad)[:5]}"
    return int(near.sum())


def eval_phase(torch, dev, tmp, results):
    """``cli.evaluate.main`` at ViT-L/14 in the ``flax`` / ``fast`` / ``int8``
    modes on ``synthetic:1024`` with a Text2SPARQL results file: B6, B3a +
    B3b and B1 launch once a layer on both towers; the serving encoders'
    embeddings agree with the module towers'; the card's ranks equal the
    CPU's on the same embeddings. Then ``fusion_sweep`` at the corpus scale
    (43,000 rows, 18 cells) and at 4,096 rows against the CPU, on rows whose
    products are exact in f32 (equal ranks, no exception). Returns
    {mode: {tower: {wrapper: launches}}}."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import evaluate as evaluate_cli
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import evaluator as EV
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import fusion as F
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import metrics as M
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    t_phase = time.perf_counter()
    arch = CM.ARCHS["ViT-L/14"]
    uuids = [f"uuid-{i:06d}" for i in range(EVAL_N)]
    t2s_path = os.path.join(tmp, "t2s_results.json")
    with open(t2s_path, "w") as f:  # every 7th query's own artefact is a hit, with one other
        json.dump({u: [f"http://kg/artefact/{u}", f"http://kg/artefact/{uuids[(31 * i) % EVAL_N]}"]
                   for i, u in enumerate(uuids) if i % 7 == 0}, f)
    kernel = {"flax": ("flash_attention_kernel",), "fast": ("fused_attention_block", "fused_mlp_block"),
              "int8": ("fused_layer_q8",)}
    towers = {"image": ("encode_image_fast", "encode_image"), "text": ("encode_text_fast", "encode_text")}
    enc, split, counts = {}, {}, {}
    for mode in ("flax", "fast", "int8"):
        targets = [(EV, "encode_dataset"), (EV, "encode_image_fast"), (EV, "encode_text_fast"),
                   (CM.CLIP, "encode_image"), (CM.CLIP, "encode_text"), (EV, "evaluate_clip_model"),
                   (EV, "evaluate_weighted"), (EV, "fusion_sweep")]
        out_dir = os.path.join(tmp, f"eval_{mode}")
        with _Spy(torch, targets) as spy:
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            report = evaluate_cli.main([
                "--model.name=ViT-L/14", f"--data.dataset=synthetic:{EVAL_N}", "--eval.batch_size=256",
                f"--eval.encoder={mode}", f"--eval.output_dir={out_dir}", f"--t2s_results={t2s_path}",
                f"--device={dev.type}",
            ])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = dispatch.launch_counts()
        enc[mode] = spy.calls["encode_dataset"][0]["result"]
        assert os.listdir(out_dir) == ["eval_ViT-L-14_zeroshot.json"], os.listdir(out_dir)
        assert report["num_samples"] == EVAL_N and len(report["fusion_sweep"]) == 18
        assert all(np.isfinite(v) for v in report["per_task"].values())
        # each tower: one launch of the mode's kernel(s) a layer a call
        counts[mode] = {}
        for tower, names in towers.items():
            layers = arch.vision_layers if tower == "image" else arch.text_layers
            for k in kernel[mode]:
                per_call = [n for name in names for n in spy.launches(name, k)]
                assert per_call and all(n == layers for n in per_call), (mode, tower, k, per_call)
                counts[mode].setdefault(tower, {})[k] = sum(per_call)
        for k in kernel[mode]:
            assert total[k] == sum(counts[mode][t][k] for t in towers), (mode, k, total[k])
        split[mode] = dict(wall_s=wall, encode_s=spy.calls["encode_dataset"][0]["seconds"],
                           metrics_s=spy.calls["evaluate_clip_model"][0]["seconds"]
                           + spy.calls["evaluate_weighted"][0]["seconds"],
                           sweep_s=spy.calls["fusion_sweep"][0]["seconds"])
        log(f"eval {mode}: cli.evaluate on synthetic:{EVAL_N} in {wall:.2f} s (model build included; host clock): "
            f"encode {split[mode]['encode_s']:.2f} s, 3-task + weighted metrics {split[mode]['metrics_s']:.3f} s, "
            f"fusion sweep (18 cells, {EVAL_N} rows) {split[mode]['sweep_s']:.3f} s; launches by tower "
            f"{counts[mode]}; T2I R@1 {report['per_task']['T2I_R@1']:.2f}, MRR {report['per_task']['T2I_MRR']:.3f}")
    for mode in ("fast", "int8"):
        cos = min(float(np.sum(getattr(enc[mode], a) * getattr(enc["flax"], a), axis=1).min())
                  for a in ("image", "query", "target"))
        log(f"eval: {mode} embeddings vs flax, min row cosine {cos:.6f} (bound {STORE_COS})")
        assert cos > STORE_COS, (mode, cos)
    # the metrics again on the CPU, from the same embeddings
    pairs = {"T2I": ("query", "image"), "I2T": ("image", "target"), "T2T": ("query", "target")}
    ties = {}
    for mode, e in enc.items():
        for task, (a, b) in pairs.items():
            qc, cc = (torch.as_tensor(getattr(e, x)) for x in (a, b))
            sim = qc @ cc.T
            got = M.diagonal_ranks(qc.to(dev) @ cc.to(dev).T).cpu().numpy()
            ties[f"{mode} {task}"] = _ranks_agree(torch, got, M.diagonal_ranks(sim).numpy(),
                                                  _near_tie_rows(torch, sim), f"eval {mode} {task}")
        cpu = EV.evaluate_clip_model(e, device="cpu")
        card = EV.evaluate_clip_model(e, device=dev)
        if not any(ties[f"{mode} {t}"] for t in pairs):  # equal ranks: equal metrics up to the mean's order
            for key, v in cpu.items():
                assert abs(card[key] - v) <= 1e-5 * max(1.0, abs(v)), (mode, key, card[key], v)
    log(f"eval: card ranks == CPU ranks on the same embeddings, except rows within {NEAR_TIE:g} of a competitor: "
        f"{ties}")

    # the fusion sweep at the corpus scale: seeded correlated unit rows on a
    # 2^-9 grid (|x| <= 0.19), so every product sum is exact in f32 in any
    # order and the card and the CPU rank identically; 1 % of the queries
    # carry five hits (their own artefact and four others)
    rng = np.random.default_rng(12)
    base = rng.standard_normal((CORPUS, WIDTH)).astype(np.float32)
    norm = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    grid = lambda a: (np.clip(np.round(a * 512.0), -97, 97) / 512.0).astype(np.float32)  # noqa: E731
    q, t, i = (grid(norm(base + s * rng.standard_normal((CORPUS, WIDTH)).astype(np.float32))) for s in (2.5, 3.0, 2.5))
    uuids = [f"uuid-{k:06d}" for k in range(CORPUS)]
    hits = {uuids[k]: [uuids[k]] + [uuids[j] for j in rng.integers(0, CORPUS, 4)]
            for k in rng.choice(CORPUS, CORPUS // 100, replace=False)}
    encoded = EV.EncodedDataset(image=i, query=q, target=t, uuids=uuids)
    EV.fusion_sweep(EV.EncodedDataset(i[:2048], q[:2048], t[:2048], uuids[:2048]), hits, block=SWEEP_BLOCK,
                    device=dev)  # warm-up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    sweep = EV.fusion_sweep(encoded, hits, block=SWEEP_BLOCK, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    assert not any(dispatch.launch_counts().values()), "the sweep is plain matrix products: no kernel of the port"
    assert len(sweep) == 18 and all(np.isfinite(v) for m in sweep.values() for v in m.values())
    cell_ms = sweep_s / len(sweep) * 1e3
    best = max(sweep, key=lambda c: sweep[c]["MRR"])
    log(f"eval: fusion_sweep at {CORPUS} x {WIDTH}, 18 cells, block {SWEEP_BLOCK}: {sweep_s:.3f} s = {cell_ms:.1f} ms "
        f"a cell (host clock, synced; f32 products, TF32 off); best cell {best} MRR {sweep[best]['MRR']:.3f}")
    # 4,096 rows: every cell's ranks on the card equal the CPU's
    n = SWEEP_CPU_ROWS
    sub = EV.EncodedDataset(image=i[:n], query=q[:n], target=t[:n], uuids=uuids[:n])
    idx, mask, _ = F.build_hit_indices(hits, sub.uuids, sub.uuids)
    qc, tc, ic = (torch.as_tensor(x) for x in (sub.query, sub.target, sub.image))
    for w_t2i, w_t2t in ((0.5, 0.5), (0.1, 0.9)):
        for alpha in (0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1):
            kw = dict(t2i_weight=w_t2i, t2t_weight=w_t2t, alpha=alpha, sparql_weight=1.0 - alpha, block=SWEEP_BLOCK)
            got = F.weighted_fusion_ranks_blocked(qc.to(dev), tc.to(dev), ic.to(dev), idx, mask, **kw).cpu().numpy()
            want = F.weighted_fusion_ranks_blocked(qc, tc, ic, idx, mask, **kw).numpy()
            assert np.array_equal(got, want), (w_t2i, w_t2t, alpha, int((got != want).sum()))
    card, cpu = EV.fusion_sweep(sub, hits, block=SWEEP_BLOCK, device=dev), EV.fusion_sweep(sub, hits, device="cpu")
    for cell, m in cpu.items():
        for key, v in m.items():  # equal ranks: equal metrics up to the mean's summation order
            assert abs(card[cell][key] - v) <= 1e-5 * max(1.0, abs(v)), (cell, key, card[cell][key], v)
    log(f"eval: fusion sweep at {n} rows: all 18 cells rank every row on the card as on the CPU; "
        f"cell t2i0.5_t2t0.5_alpha0.5 MRR {card['t2i0.5_t2t0.5_alpha0.5']['MRR']:.3f}")
    results["eval"] = dict(split=split, sweep_s=sweep_s, sweep_cell_ms=cell_ms, ties=ties,
                           phase_s=time.perf_counter() - t_phase)
    log(f"eval phase: {results['eval']['phase_s']:.1f} s")
    return counts


def fusion_phase(torch, dev, tmp, store_path, results):
    """``cli.train_fusion.main`` (``int8`` encoder, the default
    ``simple_gated`` head), the five other heads trained on the same frozen
    embeddings, each head's scores on the card against the CPU; then
    ``cli.serve --http`` at ViT-L/14 ``int8`` with ``--fusion.head_params``
    over the 43,000-row store: 8 clients x 8 ``{"fused": true}`` requests,
    each answer against the engine called directly, the head's scores
    against the CPU head over the same candidates, B2 q8 once a stage-1
    batch. Returns {path: {wrapper: launches}}."""
    import gzip
    import threading

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve as S
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train_fusion as train_fusion_cli
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import ARCHS
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fusion_heads import FUSION_TYPES, FusionModel
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.fusion_trainer import load_fusion_head, train_fusion_head
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

    t_phase = time.perf_counter()
    arch = ARCHS["ViT-L/14"]
    counts, heads = {}, {}
    head_path = os.path.join(tmp, "fusion_head.npz")
    with _Spy(torch, [(train_fusion_cli, "encode_dataset")]) as spy:
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        report = train_fusion_cli.main([
            "--model.name=ViT-L/14", f"--data.dataset=synthetic:{FUSION_N}", "--eval.batch_size=256",
            "--eval.encoder=int8", "--train.epochs=3", "--train.batch_size=64", "--train.lr=1e-3",
            f"--out={head_path}", f"--device={dev.type}",
        ])
        torch.cuda.synchronize()
        train_cli_s = time.perf_counter() - t0
        counts["train_fusion"] = dispatch.launch_counts()
    enc = spy.calls["encode_dataset"][0]["result"]
    batches = 2 * -(-FUSION_N // 256)  # the train and the test split
    want_b1 = batches * (arch.vision_layers + 2 * arch.text_layers)
    assert counts["train_fusion"]["fused_layer_q8"] == want_b1, (counts["train_fusion"], want_b1)
    with open(os.path.splitext(head_path)[0] + ".metrics.json") as f:
        history = json.load(f)["history"]["loss"]
    assert len(history) == 3 and all(np.isfinite(history))
    log(f"fusion: cli.train_fusion (int8, simple_gated, synthetic:{FUSION_N}, 3 epochs) in {train_cli_s:.2f} s "
        f"(model build and two encodes included; host clock): loss {history}; FUSION_MRR "
        f"{report['fusion']['FUSION_MRR']:.3f} vs BASELINE_MRR {report['baseline']['BASELINE_MRR']:.3f}; "
        f"B1 {counts['train_fusion']['fused_layer_q8']} = {batches} batches x "
        f"({arch.vision_layers} + 2 x {arch.text_layers}) layers")

    # the other five heads on the same frozen embeddings, and every head on the card against the CPU
    fm0, heads["simple_gated"] = load_fusion_head(head_path, device=dev)
    assert fm0.fusion_type == "simple_gated" and fm0.embed_dim == WIDTH
    train_s = {}
    for ft in FUSION_TYPES:
        fm = FusionModel(ft, WIDTH)
        if ft != "simple_gated":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            heads[ft], hist = train_fusion_head(fm, enc, epochs=HEAD_EPOCHS, batch_size=64, lr=1e-3, seed=0, device=dev)
            torch.cuda.synchronize()
            train_s[ft] = time.perf_counter() - t0
            assert all(np.isfinite(hist["loss"])), (ft, hist)
        q, i, t = (torch.as_tensor(x) for x in (enc.query[:64], enc.image, enc.target))
        with torch.no_grad():
            got = fm.scores(heads[ft], q.to(dev), i.to(dev), t.to(dev)).cpu().numpy()
            cpu_head = FusionModel(ft, WIDTH).init(0)
            cpu_head.load_state_dict({k: v.cpu() for k, v in heads[ft].state_dict().items()})
            want = fm.scores(cpu_head, q, i, t).numpy()
        np.testing.assert_allclose(got, want, err_msg=ft, **TOL_HEAD_CARD)
    log(f"fusion: the five other heads trained {HEAD_EPOCHS} epochs on the {FUSION_N} frozen rows (s, host clock, "
        f"synced): {', '.join(f'{k} {v:.2f}' for k, v in train_s.items())}; all six heads' scores [64 x {FUSION_N}] "
        f"on the card == on the CPU (rtol {TOL_HEAD_CARD['rtol']:g}, atol {TOL_HEAD_CARD['atol']:g})")

    # the daemon, serving the trained head
    vocab = os.path.join(tmp, "bpe_fused.txt.gz")
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    os.environ["CLIP_BPE_PATH"] = vocab
    args = ["--model.name=ViT-L/14", "--http=0", "--http-host=127.0.0.1", "--eval.encoder=int8",
            "--eval.quantize_corpus=int8", f"--fusion.head_params={head_path}"]
    opts = S.pop_daemon_flags(args)
    cfg = config_from_argv(args)
    engine = S.build_engine(cfg, store_path, dev)
    retriever = engine.clip_retriever
    fm, head = engine.fusion_head
    server = S.make_http_server(engine, cfg, store_path, opts).start()
    base = "http://{}:{}".format(*server.address)
    rng = np.random.default_rng(13)
    words = ["cat", "hel", "hello", "ca", "he"]
    queries = [" ".join(rng.choice(words, size=rng.integers(2, 12))) for _ in range(64)]
    _http(base, "POST", "/search", {"query": queries[0], "n": 20, "fused": True})  # warm-up
    lat, answers, errors = [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(FUSED_CLIENTS + 1)

    def client(cid):
        crng = np.random.default_rng(200 + cid)
        barrier.wait()
        for r in range(FUSED_REQUESTS):
            q = queries[cid * FUSED_REQUESTS + r]
            alpha = None if crng.random() < 0.5 else float(crng.uniform(0.2, 0.8))
            t0 = time.perf_counter()
            try:
                out = _http(base, "POST", "/search", {"query": q, "n": 20, "fused": True}
                            | ({} if alpha is None else {"alpha": alpha}))
                with lock:
                    lat.append(time.perf_counter() - t0)
                    answers.append((q, cfg.fusion.alpha_clip if alpha is None else alpha, out["results"]))
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,)) for c in range(FUSED_CLIENTS)]
    for th in threads:
        th.start()
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["fused daemon"] = dispatch.launch_counts()
    server.close()
    if errors:
        raise AssertionError(f"{len(errors)} fused requests failed: {errors[:3]}")
    n_req = FUSED_CLIENTS * FUSED_REQUESTS
    assert len(answers) == n_req
    # {"fused": true} bypasses the MicroBatcher: each request is one stage-1 batch
    got = counts["fused daemon"]
    assert got["similarity_topk_kernel"] == n_req, got
    assert got["fused_layer_q8"] == n_req * arch.text_layers, got
    for q, a, res in answers:
        want = engine.retrieve_text_fused_batch([q], alpha_clip=[a])[0][:20]
        assert len(res) == 20
        _same_lists(res, want, TOL_FUSED, f"fused {q!r} alpha {a}")
    lat_ms = sorted(x * 1e3 for x in lat)
    fused = dict(requests=n_req, wall_s=wall, qps=n_req / wall, p50_ms=lat_ms[len(lat_ms) // 2],
                 p99_ms=lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))])

    # the head's scores against the CPU head over the same candidates, at
    # top_k 20 (fetch 80) and at the retriever's default 100 (fetch 400:
    # B2's running lists in the candidate buffer)
    cpu_head = FusionModel(fm.fusion_type, fm.embed_dim).init(0)
    cpu_head.load_state_dict({k: v.cpu() for k, v in head.state_dict().items()})
    row = {u: k for k, u in enumerate(retriever.store.uuids)}
    qe = retriever.encode_queries(queries[:16]).float().cpu()
    for top_k in (20, 100):
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        res = retriever.retrieval_fused_batch(queries[:16], fm, head, alpha=0.5, top_k=top_k, factor=cfg.fusion.factor)
        torch.cuda.synchronize()
        counts[f"fused top_k={top_k}"] = dispatch.launch_counts()
        assert counts[f"fused top_k={top_k}"]["similarity_topk_kernel"] == 1, counts[f"fused top_k={top_k}"]
        for qi, r in enumerate(res):
            assert len(r) == top_k
            rows = [row[x["uuid"]] for x in r]
            with torch.no_grad():
                want = fm.scores(cpu_head, qe[qi : qi + 1], torch.as_tensor(retriever.store.image[rows]),
                                 torch.as_tensor(retriever.store.text[rows]))[0].numpy()
            np.testing.assert_allclose([x["score"] for x in r], want, err_msg=f"top_k {top_k}", **TOL_HEAD)
    log(f"fusion daemon (ViT-L/14 int8, int8 corpus {CORPUS} rows, simple_gated head, factor {cfg.fusion.factor}, "
        f"fetch {cfg.fusion.factor * retriever.top_k}): {n_req} fused requests from {FUSED_CLIENTS} clients in "
        f"{wall:.3f} s = {fused['qps']:.1f} requests/s; p50 {fused['p50_ms']:.2f} ms, p99 {fused['p99_ms']:.2f} ms "
        f"(host clock, client threads); launches {got}; every answer == engine.retrieve_text_fused_batch; head "
        f"scores == the CPU head over the same candidates at top_k 20 and 100 (rtol {TOL_HEAD['rtol']:g})")
    del engine, retriever, server, head, heads
    torch.cuda.empty_cache()
    results["fusion"] = dict(train_cli_s=train_cli_s, head_train_s=train_s, fused=fused,
                             phase_s=time.perf_counter() - t_phase)
    log(f"fusion phase: {results['fusion']['phase_s']:.1f} s")
    return counts


def quality_phase(torch, dev, tmp, results):
    """The quality sweep and the autotuner (the port's scripts) on the
    capacity phase's clustered 43,000-row store, 256 queries, k = 10: the
    int8 / int4 / pq rows through B2, B2-q4 and B5, their recall against the
    served tiers' recall@10 on the same 256 corpus rows; then the card-
    versus-CPU consistency check. Returns {row kind: {wrapper: launches}}."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import quality as Q
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import autotune as autotune_script
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import consistency_check
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import quality_sweep as sweep_script

    t_phase = time.perf_counter()
    store = os.path.join(tmp, "clustered.npz")
    wrapped = ("fused_similarity_topk_q8", "fused_similarity_topk_q4", "pq_similarity_topk")
    common = ["--store", store, "--queries", str(QUERIES), "--k", "10", f"--device={dev.type}"]
    with _Spy(torch, [(Q, n) for n in wrapped]) as spy:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        out = sweep_script.main(common + ["--nprobes", str(NPROBE)])
        sweep_s = time.perf_counter() - t0
        total = dispatch.launch_counts()
        counts = {"int8": sum(spy.launches("fused_similarity_topk_q8", "similarity_topk_kernel")),
                  "int4": sum(spy.launches("fused_similarity_topk_q4", "similarity_topk_kernel")),
                  "pq": sum(spy.launches("pq_similarity_topk", "pq_adc_topk_kernel"))}
    # one launch a row and a fetch (k, the rerank fetch)
    assert counts == {"int8": 2, "int4": 2, "pq": 2}, counts
    assert (total["similarity_topk_kernel"], total["pq_adc_topk_kernel"]) == (4, 2), total
    rows = {r["config"]: r for r in out["rows"]}
    cap = results["capacity_tiers"]
    diffs = {}
    for tier in ("int4", "pq"):
        diffs[tier] = rows[tier]["recall_at_k"] - cap[tier]["recall_at_10_corpus_rows"]
    log(f"quality: quality_sweep on the clustered store ({CORPUS} rows, {QUERIES} corpus rows as queries, k 10, "
        f"--nprobes {NPROBE}) in {sweep_s:.1f} s (host clock; codebook training included); "
        f"{len(rows)} rows; launches B2 q8 {counts['int8']}, B2-q4 {counts['int4']}, B5 {counts['pq']}; recall@10 "
        + "; ".join(f"{r} {rows[r]['recall_at_k']:.4f}" for r in rows if r != "exact")
        + f"; against the served tiers' recall@10 on the same rows: {diffs}")
    for tier, d in diffs.items():
        assert abs(d) <= TOL_RECALL, (tier, rows[tier]["recall_at_k"], cap[tier]["recall_at_10_corpus_rows"])
    with _Spy(torch, [(Q, n) for n in wrapped]) as spy:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        rec = autotune_script.main(common + ["--recall-target", "0.95", "--no-rotate"])
        autotune_s = time.perf_counter() - t0
        total = dispatch.launch_counts()
        counts["autotune"] = {"int8": sum(spy.launches("fused_similarity_topk_q8", "similarity_topk_kernel")),
                              "int4": sum(spy.launches("fused_similarity_topk_q4", "similarity_topk_kernel")),
                              "pq": sum(spy.launches("pq_similarity_topk", "pq_adc_topk_kernel"))}
    assert counts["autotune"] == {"int8": 2, "int4": 2, "pq": 2}, counts["autotune"]
    assert (total["similarity_topk_kernel"], total["pq_adc_topk_kernel"]) == (4, 2), total
    assert rec["predicted_recall_at_k"] >= 0.95
    log(f"quality: autotune (--recall-target 0.95 --no-rotate) in {autotune_s:.1f} s: {rec['config']} "
        f"(recall@10 {rec['predicted_recall_at_k']:.4f}, {rec['capacity_multiplier']:.0f}x capacity), flags "
        f"{rec['serve_flags']!r}")
    t0 = time.perf_counter()
    rc = consistency_check.main([f"--device={dev.type}"])
    assert rc == 0, "consistency_check: the card's f32 evaluation differs from the CPU's"
    results["quality"] = dict(sweep_s=sweep_s, autotune_s=autotune_s, recall_diff=diffs,
                              consistency_s=time.perf_counter() - t0, phase_s=time.perf_counter() - t_phase)
    log(f"quality phase: {results['quality']['phase_s']:.1f} s")
    return counts


# -- items 18-21: checkpoint layouts, the parity runbook, text baselines, the profiling scripts --

PARITY_N = 256  # synthetic examples each real-mode parity run evaluates (one batch)
BASELINE_N, BASELINE_VARIANTS, BASELINE_DIM = 4_300, 5, 768  # the 43k corpus's test split; HashTextEncoder width
TOL_BASELINE = 1e-6  # card metrics against the CPU's on the same embeddings, where no near ties exist
# a 768-d f32 dot product of unit rows is off by at most D * 2^-24 (~4.6e-5; measured up to 1.1e-5 on the card,
# 5.6e-6 on its host), so two candidates closer than twice that to each other may order either way
NEAR_TIE_F32 = 2 * BASELINE_DIM * 2.0 ** -24
# the JAX dry run's pinned stage statuses (tests/test_parity_runbook.py:18-36)
PARITY_DRY_STAGES = {"tokenizer": "skipped", "converter_openai": "ok", "converter_hf": "skipped", "evaluation": "ok"}


class _Tally(_Spy):
    """A :class:`_Spy` that adds each call's kernel launches to the wrapped
    name's tally, without a synchronize: the launch counters move on the
    host at launch time, so the timing loops inside the path stay
    undisturbed."""

    def __init__(self, targets):
        super().__init__(None, targets)
        self.tally = {name: {} for _, name in targets}

    def _wrap(self, name, fn):
        def tally(*a, **kw):
            before = self.dispatch.launch_counts()
            out = fn(*a, **kw)
            after = self.dispatch.launch_counts()
            for k, n in after.items():
                if n != before[k]:
                    self.tally[name][k] = self.tally[name].get(k, 0) + n - before[k]
            return out

        return tally

    def of(self, name, kernel):
        return self.tally[name].get(kernel, 0)


def checkpoint_layouts_phase(torch, dev, ckpt_dir, store_path, model, results):
    """The ViT-L/14 weights written by the port's own writers as an OpenAI
    ``.pt``, an HF-layout state-dict ``.pt`` and a flax ``.npz``; each loaded
    through ``cli.common.build_model`` (``--model.checkpoint``) to parameters
    bit-identical to the model they were written from; one 256-query ``int8``
    batch and one ``fast`` batch served through each (top-k rows equal,
    scores within 1e-5). Returns ({mode: {wrapper: launches}}, the OpenAI
    ``.pt`` path)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.common import build_model as cli_build_model
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import convert as CV
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

    t_phase = time.perf_counter()
    writers = {"openai .pt": (CV.save_openai_pt, "vit_l14_openai.pt"), "hf .pt": (CV.save_hf_pt, "vit_l14_hf.pt"),
               "flax .npz": (CV.save_params_npz, "vit_l14_flax.npz")}
    sd = CV.openai_state_dict(model)
    paths, write_s, load_s, size_gb = {}, {}, {}, {}
    for name, (writer, fname) in writers.items():
        paths[name] = os.path.join(ckpt_dir, fname)
        t0 = time.perf_counter()
        writer(sd, paths[name])
        write_s[name] = time.perf_counter() - t0
        size_gb[name] = os.path.getsize(paths[name]) / 2**30
    del sd
    ref = model.state_dict()
    models = {}
    for name, path in paths.items():
        t0 = time.perf_counter()
        models[name] = cli_build_model(config_from_argv([f"--model.checkpoint={path}"]), dev)
        torch.cuda.synchronize()
        load_s[name] = time.perf_counter() - t0
        got = models[name].state_dict()
        assert got.keys() == ref.keys(), name
        bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        assert not bad, f"{name}: parameters differ from the written model: {bad[:4]}"
    log(f"checkpoints: ViT-L/14 written by the port's writers and loaded through cli.common.build_model, "
        f"parameters bit-identical: " + "; ".join(
            f"{n} {size_gb[n]:.2f} GB, write {write_s[n]:.1f} s, load {load_s[n]:.1f} s" for n in paths))

    tok, store = CLIPTokenizer(MERGES), EmbeddingStore.load(store_path)
    rng = np.random.default_rng(21)
    words = ["cat", "hel", "hello", "ca", "he"]
    queries = [" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)]
    counts, serve_ms = {}, {}
    for mode, kw in (("int8", dict(quantize="int8", quantize_corpus="int8")),
                     ("fast", dict(corpus_dtype=torch.bfloat16))):
        retrievers = {n: CLIPRetrieval(m, tok, store, device=dev, top_k=K, use_fused_encoder=True, **kw)
                      for n, m in models.items()}
        for r in retrievers.values():
            r.search_batch(queries[:8])  # warm-up
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        outs = {}
        for n, r in retrievers.items():
            t0 = time.perf_counter()
            vals, idx = r.search_batch(queries)
            outs[n] = (vals.float().cpu().numpy(), idx.cpu().numpy())
            serve_ms[f"{mode} {n}"] = (time.perf_counter() - t0) * 1e3
        counts[mode] = dispatch.launch_counts()
        want_v, want_i = outs["openai .pt"]
        assert want_v.shape == (QUERIES, K) and np.isfinite(want_v).all()
        for n, (v, i) in outs.items():
            assert np.array_equal(i, want_i), f"{mode} {n}: top-k rows differ from the OpenAI .pt model's"
            np.testing.assert_allclose(v, want_v, rtol=0, atol=TOL_TOPK, err_msg=f"{mode} {n}")
        log(f"checkpoints: {mode} batch of {QUERIES} through each layout's model: rows equal, scores within "
            f"{TOL_TOPK:g}; launches {counts[mode]}")
        del retrievers
    del models
    torch.cuda.empty_cache()
    results["checkpoints"] = dict(write_s=write_s, load_s=load_s, size_gb=size_gb, serve_ms=serve_ms,
                                  phase_s=time.perf_counter() - t_phase)
    log(f"checkpoint layouts phase: {results['checkpoints']['phase_s']:.1f} s")
    return counts, paths["openai .pt"]


def parity_phase(torch, dev, ckpt_dir, pt_path, model, results):
    """``cli.parity``: the dry run's stage statuses equal the JAX dry run's
    pins; then real mode with the ViT-L/14 ``.pt`` as ``CLIP_PT_PATH`` on
    ``synthetic:256`` in the ``flax`` / ``fast`` / ``int8`` encoders:
    ``converter_openai`` and ``evaluation`` ``ok`` with R@K numbers.
    ``CLIP_HF_PATH`` (an HF export of the same weights) is set for the first
    run only if ``transformers`` imports here. Returns {encoder: {tower:
    {wrapper: launches}}}."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import parity
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import evaluator as EV
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import convert as CV
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    t_phase = time.perf_counter()
    saved_env = {v: os.environ.pop(v, None) for v in ("CLIP_BPE_PATH", "CLIP_PT_PATH", "CLIP_HF_PATH")}
    try:
        t0 = time.perf_counter()
        rep = parity.main(["--dry-run", "--out", os.path.join(ckpt_dir, "parity_dry.json"), f"--device={dev.type}"])
        assert rep["ok"] and rep["stages"] == PARITY_DRY_STAGES, rep["stages"]
        assert rep["results"]["converter_openai"]["finite"] is True
        assert rep["results"]["evaluation"]["num_samples"] == 32
        dry_s = time.perf_counter() - t0
        log(f"parity: dry run stages {rep['stages']} (the JAX dry run's) in {dry_s:.1f} s")
        try:
            import transformers
        except ImportError:
            transformers = None
        hf_dir = None
        if transformers is None:
            log("parity: transformers does not import here: CLIP_HF_PATH left unset, converter_hf skips")
        else:
            t0 = time.perf_counter()
            hf_dir = CV.export_hf_checkpoint(model, model.arch, os.path.join(ckpt_dir, "hf_export"))
            log(f"parity: transformers {transformers.__version__} imports here: CLIP_HF_PATH set to an HF export "
                f"of the same weights ({time.perf_counter() - t0:.1f} s) for the flax run")
        os.environ["CLIP_PT_PATH"] = pt_path
        towers = {"image": ("encode_image_fast", "encode_image"), "text": ("encode_text_fast", "encode_text")}
        counts, reports, run_s = {}, {}, {}
        for enc in ("flax", "fast", "int8"):
            if hf_dir and enc == "flax":
                os.environ["CLIP_HF_PATH"] = hf_dir
            targets = [(EV, "encode_image_fast"), (EV, "encode_text_fast"), (CM.CLIP, "encode_image"),
                       (CM.CLIP, "encode_text")]
            with _Tally(targets) as tl:
                torch.cuda.synchronize()
                dispatch.reset_launch_counts()
                t0 = time.perf_counter()
                rep = parity.main(["--out", os.path.join(ckpt_dir, f"parity_{enc}.json"), f"--device={dev.type}",
                                   f"--data.dataset=synthetic:{PARITY_N}", f"--eval.encoder={enc}",
                                   f"--eval.batch_size={PARITY_N}"])
                torch.cuda.synchronize()
                run_s[enc] = time.perf_counter() - t0
            os.environ.pop("CLIP_HF_PATH", None)
            st = rep["stages"]
            want_hf = "ok" if hf_dir and enc == "flax" else "skipped"
            assert (st["tokenizer"], st["converter_openai"], st["converter_hf"], st["evaluation"]) == (
                "skipped", "ok", want_hf, "ok"), (enc, st, {k: v.get("error") for k, v in rep["results"].items()})
            ev = rep["results"]["evaluation"]
            assert ev["num_samples"] == PARITY_N and any(k.startswith("T2I_R@") for k in ev["per_task"])
            assert all(np.isfinite(v) for v in ev["per_task"].values())
            counts[enc] = {t: {k: sum(tl.of(n, k) for n in names) for k in dispatch.launch_counts()}
                           for t, names in towers.items()}
            reports[enc] = {"stages": st, "converter_openai": rep["results"]["converter_openai"],
                            "converter_hf": rep["results"]["converter_hf"].get("cosine"),
                            "T2I_R@1": ev["per_task"]["T2I_R@1"], "T2T_R@10": ev["per_task"]["T2T_R@10"]}
            log(f"parity {enc}: stages {st} in {run_s[enc]:.1f} s; T2I R@1 {ev['per_task']['T2I_R@1']:.2f}, "
                f"T2T R@10 {ev['per_task']['T2T_R@10']:.2f}; converter_hf cosine "
                f"{rep['results']['converter_hf'].get('cosine')}; launches by tower "
                f"{ {t: {k: n for k, n in c.items() if n} for t, c in counts[enc].items()} }")
    finally:
        for var, value in saved_env.items():
            os.environ.pop(var, None)
            if value is not None:
                os.environ[var] = value
    results["parity"] = dict(dry_s=dry_s, run_s=run_s, reports=reports, hf=bool(hf_dir),
                             phase_s=time.perf_counter() - t_phase)
    log(f"parity phase: {results['parity']['phase_s']:.1f} s")
    return counts


def _variant_texts(n, v, seed):
    """``n`` artefacts x ``v`` text variants: an artefact word and random
    words; every 7th artefact repeats one text in all its variants."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(400)]
    return [[f"artifact {i} " + " ".join(rng.choice(words, rng.integers(3, 12))) for _ in range(v)] if i % 7
            else [f"artifact {i} " + " ".join(rng.choice(words, 5))] * v for i in range(n)]


def baseline_phase(torch, dev, results):
    """``evaluate_text_model`` (``single`` and ``multi``) and
    ``evaluate_lm_query_target`` with ``HashTextEncoder`` (768 dims) at
    4,300 artefacts x 5 variants on the card, against the port's CPU run of
    the same inputs: grouped ranks equal except queries with other
    artefacts' candidates within ``NEAR_TIE_F32`` (2 x 768 x 2^-24, the f32
    dot product's rounding bound; 1e-5 is below what the card was measured
    to round) of their best (f64 products, equal ones included; those may
    move by as many ranks as such candidates),
    metrics within 1e-6 where no such query exists. The hash encoder's 768
    dims repeat four digest bytes, so such ties are common."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.baselines import text_models as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import metrics as MET

    t_phase = time.perf_counter()
    texts = _variant_texts(BASELINE_N, BASELINE_VARIANTS, seed=13)
    enc = TT.HashTextEncoder(BASELINE_DIM)
    emb = [torch.as_tensor(enc.encode([t[v] for t in texts])) for v in range(BASELINE_VARIANTS)]
    out, near_by_mode = {}, {}
    for mode in ("single", "multi"):
        t0 = time.perf_counter()
        card = TT.evaluate_text_model(enc, texts, mode=mode, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        cpu = TT.evaluate_text_model(enc, texts, mode=mode, device="cpu")
        near = 0
        for qv in ([0] if mode == "single" else range(BASELINE_VARIANTS)):
            pool, groups = TT._pool(emb, qv)
            got = TT.grouped_ranks(emb[qv].to(dev) @ pool.to(dev).T, groups.to(dev)).cpu()
            want = TT.grouped_ranks(emb[qv] @ pool.T, groups)
            sim = emb[qv].to(dev).double() @ pool.to(dev).double().T
            own = groups.to(dev)[None, :] == torch.arange(BASELINE_N, device=dev)[:, None]
            best = torch.where(own, sim, -torch.inf).amax(1)
            # other artefacts' candidates within NEAR_TIE_F32 of the best (f64 ties included: two f32 sums
            # in another order can split them) may order either way against it
            window = (((sim - best[:, None]).abs() < NEAR_TIE_F32) & ~own).sum(1).cpu()
            is_near = window > 0
            near += int(is_near.sum())
            assert torch.equal(got[~is_near], want[~is_near]), (mode, qv, int((got != want).sum()))
            assert ((got - want).abs() <= window).all(), (mode, qv)
        if near == 0:
            for key, v in cpu.items():
                assert abs(card[key] - v) <= TOL_BASELINE * max(1.0, abs(v)), (mode, key, card[key], v)
        out[mode], near_by_mode[mode] = dict(card=card, card_s=card_s), near
        log(f"baseline {mode}: {BASELINE_N} x {BASELINE_VARIANTS} variants, HashTextEncoder({BASELINE_DIM}) on the "
            f"card in {card_s:.3f} s: R@1 {card['T2T_R@1']:.3f}, MRR {card['T2T_MRR']:.3f}; ranks equal the CPU's "
            f"({near} near-tie queries within {NEAR_TIE_F32:.3g} excepted)")
    queries, targets = [t[0] for t in texts], [t[1] for t in texts]
    card = TT.evaluate_lm_query_target(enc, queries, targets, device=dev)
    cpu = TT.evaluate_lm_query_target(enc, queries, targets, device="cpu")
    q, t = (torch.as_tensor(enc.encode(x)) for x in (queries, targets))
    sim = q.to(dev).double() @ t.to(dev).double().T
    other = ~torch.eye(BASELINE_N, dtype=torch.bool, device=dev)
    window = (((sim - torch.diagonal(sim)[:, None]).abs() < NEAR_TIE_F32) & other).sum(1).cpu()
    is_near = window > 0
    got, want = MET.diagonal_ranks(q.to(dev) @ t.to(dev).T).cpu(), MET.diagonal_ranks(q @ t.T)
    assert torch.equal(got[~is_near], want[~is_near]) and ((got - want).abs() <= window).all()
    if not bool(is_near.any()):
        for key, v in cpu.items():
            assert abs(card[key] - v) <= TOL_BASELINE * max(1.0, abs(v)), ("lm", key, card[key], v)
    out["lm_query_target"] = card
    near_by_mode["lm_query_target"] = int(is_near.sum())
    results["baseline"] = dict(out, near=near_by_mode, phase_s=time.perf_counter() - t_phase)
    log(f"baseline lm_query_target: R@1 {card['T2T_R@1']:.3f} ({int(is_near.sum())} near ties); "
        f"baseline phase {results['baseline']['phase_s']:.1f} s (no kernel of the port: plain products on the card)")


PQ_PROFILE_ROWS = 21_504  # profile_pq's corpus here (its default 43,000 spends ~20 s in host PQ k-means)
IVF_ROWS = 4_096  # profile_ivf's corpus: half the 8,192 rows its PQ host k-means would train on (default 262,144)
SCALE_BENCH_ROWS = 32_768  # scale_bench's corpus here (1M rows spend ~55 s in host copies and quantization)
SCRIPT_RUNS = {  # name: (argv, the module's scan functions tallied by name) -- repeats and profile_ivf's rows cut, widths kept
    "profile_serving": (["--iters=10"], ("fused_similarity_topk", "fused_similarity_topk_q8")),
    "profile_vision": (["--iters=5"], ()),
    "vision_batch_sweep": (["--bf16", "--medians=2", "--iters=3", "--batches=64,256"], ()),
    "profile_pq": (["--iters=10", f"--n={PQ_PROFILE_ROWS}"], ("fused_similarity_topk", "fused_similarity_topk_q8", "fused_similarity_topk_q4",
                                    "fused_pq_topk")),
    "profile_ivf": (["--repeats=5", f"--n={IVF_ROWS}"], ("fused_similarity_topk_q8",)),
    "scale_bench": ([f"--rows={SCALE_BENCH_ROWS}", "--iters=5"], ("fused_similarity_topk_q8", "fused_similarity_topk_q4",
                                                            "pq_similarity_topk")),
}


def profiling_scripts_phase(torch, dev, results):
    """Each of the port's six profiling scripts once through its
    ``main(argv)`` on the card at full width, repeats cut
    (``SCRIPT_RUNS``); its JSON is logged and written under ``chiprun_out/``.
    Returns {script: {"total": {wrapper: launches}, scan function: {...}}}."""
    import importlib

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    t_phase = time.perf_counter()
    counts, wall, payloads = {}, {}, {}
    for name, (argv, scans) in SCRIPT_RUNS.items():
        mod = importlib.import_module(f"{PKG}.scripts.{name}")
        with _Tally([(mod, s) for s in scans]) as tl:
            torch.cuda.synchronize()
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            payloads[name] = mod.main(argv + [f"--device={dev.type}"])
            torch.cuda.synchronize()
            wall[name] = time.perf_counter() - t0
            total = dispatch.launch_counts()
            counts[name] = {"total": total, **{f: {k: tl.of(f, k) for k in total} for f in scans}}
        log(f"script {name}: {wall[name]:.1f} s, launches {({k: n for k, n in counts[name]['total'].items() if n})}; "
            f"JSON in {mod.DEFAULT_OUT}")
    # what comes out is right: every timed line finite and positive, the
    # scans' recall where the exact answer is known
    ps, pv, vs = payloads["profile_serving"], payloads["profile_vision"], payloads["vision_batch_sweep"]
    pq, ivf, sb = payloads["profile_pq"], payloads["profile_ivf"], payloads["scale_bench"]
    lines = [*ps["lines"].values(), *pv["blocks"].values(), *pq["tiers"].values(), *ivf["lines"].values(),
             *sb["tiers"].values(), *(t["full"] for t in pv["towers"].values()),
             *(r["ms_per_batch"] for r in vs["results"].values())]
    assert all(np.isfinite(x["event_ms"]) and x["event_ms"] > 0 and np.isfinite(x["device_ms"]) for x in lines)
    assert sb["failed_tiers"] == {} and set(sb["tiers"]) == {"int8", "int4", "pq"} and sb["rows"] == SCALE_BENCH_ROWS
    assert sb["tiers"]["int8"]["recall@10"] >= 0.9 and pq["tiers"]["bf16 exact"]["recall@10"] >= 0.99
    assert abs(pq["tiers"]["pq m=96 adc"]["recall@10"] - pq["tiers"]["pq m=96 decode"]["recall@10"]) <= 0.02
    assert ivf["lines"]["brute int8"]["recall@10"] >= 0.9
    results["scripts"] = dict(wall_s=wall, phase_s=time.perf_counter() - t_phase)
    log(f"profiling scripts phase: {results['scripts']['phase_s']:.1f} s")
    return counts


TRAIN_N, TRAIN_BATCH = 128, 64  # synthetic:128 at TrainConfig.batch_size: 2 steps an epoch
TRAIN_BENCH_STEPS = 3  # train_bench steps timed a point (event and device-only medians)
TRAIN_SMALL_LAYERS, TRAIN_SMALL_BATCH = 1, 4  # the card-vs-CPU step: ViT-L/14 widths, 1 layer a tower
TRAIN_VARIANT_LAYERS = (4, 2)  # the variant runs: ViT-L/14 widths, depth cut (vision, text) to keep the phase short
OVERFIT_STEPS, OVERFIT_LR = 8, 2e-5
TOL_GRAD_COS, TOL_LOSS_BF16, TOL_F32 = 0.99, 1e-2, 1e-4


class _LaunchTally:
    """B6 launches by path during the training runs: the towers' forward
    (class-level wrappers, so validation's ``functional_call`` counts too),
    each train or distill step (the remat recompute in the backward is the
    step's launches outside the towers) and validation; and CUDA events
    around every step. ``run`` names the cli.train run in progress."""

    def __init__(self, torch, CM, TT, dispatch):
        self.torch, self.CM, self.TT, self.dispatch = torch, CM, TT, dispatch
        self.run, self.part = "", "train"
        self.by = {}
        self.events = {}
        self._saved = []

    def _b6(self):
        return self.dispatch.launch_counts()["flash_attention_kernel"]

    def _add(self, key, n):
        self.by[key] = self.by.get(key, 0) + n

    def __enter__(self):
        tally, torch = self, self.torch

        def tower(fn, label):
            def wrapper(module, *args, **kw):
                before = tally._b6()
                out = fn(module, *args, **kw)
                tally._add((tally.run, tally.part, label), tally._b6() - before)
                return out
            return wrapper

        def make_step(fn):
            def wrapped_make(*a, **kw):
                step = fn(*a, **kw)

                def timed(state, batch):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    before = tally._b6()
                    start.record()
                    out = step(state, batch)
                    end.record()
                    tally.events.setdefault(tally.run, []).append((start, end))
                    tally._add((tally.run, "train", "step"), tally._b6() - before)
                    return out
                return timed
            return wrapped_make

        def validate(fn):
            def wrapper(trainer):
                tally.part = "validation"
                try:
                    return fn(trainer)
                finally:
                    tally.part = "train"
            return wrapper

        for owner, attr, wrap in ((self.CM.VisionTransformer, "forward", lambda f: tower(f, "image")),
                                  (self.CM.TextTransformer, "forward", lambda f: tower(f, "text")),
                                  (self.TT, "make_train_step", make_step),
                                  (self.TT, "make_distill_step", make_step),
                                  (self.TT.CLIPTrainer, "validate", validate)):
            orig = getattr(owner, attr)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, wrap(orig))
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)

    def step_ms(self, run):
        """Event ms of the run's steps 2..n (the first builds the optimizer state)."""
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events.get(run, [])[1:]]

    def count(self, runs, part, label):
        return sum(self.by.get((r, part, label), 0) for r in runs)


def _card_vs_cpu_steps(torch, dev, results):
    """ViT-L/14 widths at 1 layer a tower, batch 4: one bf16 train step on
    the card against the CPU (plain versions) -- per-tensor gradient cosine
    over the tensors with a nonzero gradient, the loss to 1e-2 -- and two f32
    steps: losses and parameters to 1e-4."""
    import dataclasses

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    arch = dataclasses.replace(CM.ARCHS["ViT-L/14"], vision_layers=TRAIN_SMALL_LAYERS, text_layers=TRAIN_SMALL_LAYERS)
    pipe = DataPipeline(make_synthetic_source(TRAIN_SMALL_BATCH, image_size=arch.image_resolution, seed=5),
                        CLIPTokenizer([]), image_size=arch.image_resolution, context_length=arch.context_length)
    host = pipe.make_batch(list(range(TRAIN_SMALL_BATCH)))
    cfg = TrainConfig(batch_size=TRAIN_SMALL_BATCH)
    out = {}
    for dtype, steps in ((torch.bfloat16, 1), (torch.float32, 2)):
        runs = {}
        for where in (dev, torch.device("cpu")):
            model = CM.build_model("", arch=arch, dtype=dtype, seed=3, device=where)
            state = TT.TrainState(model, TT.make_optimizer(cfg, 4, model))
            step = TT.make_train_step(model, cfg)
            grads, losses = {}, []
            orig = state.optimizer.step
            state.optimizer.step = lambda g, orig=orig: (
                grads.update({k: v.detach().float().cpu().clone() for k, v in g.items()}), orig(g))
            batch = {k: torch.from_numpy(getattr(host, k)).to(where) for k in ("images", "query_ids", "target_ids")}
            for _ in range(steps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            runs[where.type] = (grads, losses, {n: p.detach().float().cpu() for n, p in model.named_parameters()})
            del model, state, step
        (g_card, l_card, p_card), (g_cpu, l_cpu, p_cpu) = runs[dev.type], runs["cpu"]
        assert all(np.isfinite(l_card)), l_card
        if dtype == torch.bfloat16:
            cos = {n: float(torch.nn.functional.cosine_similarity(g_card[n].flatten(), g_cpu[n].flatten(), dim=0))
                   for n in g_cpu if g_cpu[n].abs().max() > 0 or g_card[n].abs().max() > 0}
            worst = min(cos, key=cos.get)
            log(f"train card vs CPU, bf16, ViT-L/14 widths x {TRAIN_SMALL_LAYERS} layers, batch {TRAIN_SMALL_BATCH}: "
                f"loss {l_card[0]:.6f} / {l_cpu[0]:.6f}; gradient cosine min {cos[worst]:.6f} ({worst}) over "
                f"{len(cos)} of {len(g_cpu)} tensors")
            assert abs(l_card[0] - l_cpu[0]) <= TOL_LOSS_BF16 * abs(l_cpu[0]), (l_card, l_cpu)
            assert cos[worst] >= TOL_GRAD_COS, (worst, cos[worst])
            out["bf16"] = dict(loss=(l_card[0], l_cpu[0]), grad_cos_min=cos[worst], worst=worst, n=len(cos))
        else:
            np.testing.assert_allclose(l_card, l_cpu, rtol=TOL_F32, err_msg="f32 losses card vs CPU")
            worst = max((float((p_card[n] - p_cpu[n]).abs().max()), n) for n in p_cpu)
            for n in p_cpu:
                np.testing.assert_allclose(p_card[n].numpy(), p_cpu[n].numpy(), rtol=TOL_F32, atol=TOL_F32, err_msg=n)
            log(f"train card vs CPU, f32, {steps} steps: losses {l_card} / {l_cpu}; parameters within {TOL_F32:g} "
                f"(max abs difference {worst[0]:.3g}, {worst[1]})")
            out["f32"] = dict(losses=(l_card, l_cpu), max_param_diff=worst[0])
    results["train"]["card_vs_cpu"] = out


def train_phase(torch, dev, tmp, store_path, results, seeded):
    """The core training loop (``cli.train``) at ViT-L/14 widths cut to
    ``TRAIN_VARIANT_LAYERS``, bf16 compute, f32 parameters, batch 64 on
    ``synthetic:128``: the reference-parity run
    (InfoNCE, t2i 0.7 / t2t 0.3, 1 epoch with validation, latest / best
    checkpoints, metrics files) and its resume to 2 epochs (starts at epoch
    1); a variant (accumulation 2, EMA 0.999, remat, FLIP 0.5: s = 129) and a
    second one (SigLIP, Matryoshka 256 / 768, frozen image encoder), 1 epoch
    each;
    ``cli.export --format openai`` of the best checkpoint loaded through
    ``load_clip_state_dict`` and served (``fast``: B3a, B3b, B2) with the
    module towers against the fast ones; 8 steps of a seeded model on one
    batch at a raised lr (the loss must fall); the card-vs-CPU steps; and
    ``scripts/train_bench.py``'s ViT-L/14 batch-64 point with and without
    remat (full depth). ``seeded``: the serving phases' seed-0
    ViT-L/14 (bf16 compute), copied for the raised-lr steps. Returns {path:
    B6 launches}."""
    import copy
    import dataclasses

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import export as EX
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train as CT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as FE
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_clip_state_dict, load_openai_state_dict
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import train_bench as TB
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import checkpoint as TC
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    t_phase = time.perf_counter()
    res = results["train"] = {}
    root = tempfile.mkdtemp(dir=tmp)  # checkpoints of 5-7 GB each, deleted run by run
    dev_flag = f"--device={dev.type}"

    # the variant runs keep ViT-L/14's widths and token counts at a cut depth
    variant_arch = "ViT-L/14 ({} + {} layers)".format(*TRAIN_VARIANT_LAYERS)
    CM.ARCHS[variant_arch] = dataclasses.replace(CM.ARCHS["ViT-L/14"], vision_layers=TRAIN_VARIANT_LAYERS[0],
                                                 text_layers=TRAIN_VARIANT_LAYERS[1])

    def argv(run, *extra):
        return [dev_flag, f"--model.name={variant_arch}", f"--data.dataset=synthetic:{TRAIN_N}",
                f"--train.batch_size={TRAIN_BATCH}", f"--eval.output_dir={root}/{run}",
                f"--train.checkpoint_dir={root}/{run}/ckpt", *extra]

    timing = {"snapshot_s": [], "write_s": [], "load_s": []}
    real = {"to_host": TC.to_host, "_write": TC._write, "load_checkpoint": TC.load_checkpoint}

    depth = [0]  # to_host recurses into the state's dicts: time the outermost call

    def timed(name, key):
        def wrapper(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return real[name](*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    timing[key].append(time.perf_counter() - t0)
        return wrapper

    runs, wall = {}, {}
    t_runs = time.perf_counter()
    torch.cuda.synchronize(dev)  # initializes the device before its memory statistics are read
    torch.cuda.reset_peak_memory_stats(dev)
    with _LaunchTally(torch, CM, TT, dispatch) as tally:
        TC.to_host, TC._write = timed("to_host", "snapshot_s"), timed("_write", "write_s")
        TC.load_checkpoint = timed("load_checkpoint", "load_s")
        try:
            for run, extra in (
                ("parity", ["--train.loss=infonce", "--train.t2i_weight=0.7", "--train.t2t_weight=0.3",
                            "--train.epochs=1"]),
                ("resume", ["--train.loss=infonce", "--train.t2i_weight=0.7", "--train.t2t_weight=0.3",
                            "--train.epochs=2", "--train.resume=true"]),
                ("variant", ["--train.grad_accum_steps=2", "--train.ema_decay=0.999", "--model.remat=true",
                             "--train.image_mask_ratio=0.5", "--train.epochs=1"]),
                ("variant2", ["--train.loss=siglip", "--train.matryoshka_dims=256,768",
                              "--train.freeze_image_encoder=true", "--train.epochs=1"]),
            ):
                tally.run = run
                out_dir = "parity" if run == "resume" else run
                t0 = time.perf_counter()
                runs[run] = CT.main(argv(out_dir, *extra))
                runs[run]["wall_s"] = time.perf_counter() - t0
                if run == "parity":
                    ck = f"{root}/parity/ckpt"
                    res["ckpt_bytes"] = os.path.getsize(f"{ck}/checkpoint_latest.pt")
                if run == "variant":
                    state, _ = TC.load_checkpoint(f"{root}/variant/ckpt", "best")
                    shadow = TC.load_params_only(f"{root}/variant/ckpt", "best")
                    assert all(torch.equal(shadow[n], state["ema_params"][n]) for n in shadow)
                    assert any(not torch.equal(shadow[n], state["params"][n]) for n in shadow), "EMA equals params"
                    res["ema_ckpt_bytes"] = os.path.getsize(f"{root}/variant/ckpt/checkpoint_best.pt")
                    del state, shadow
                if out_dir != "parity":  # the parity run's checkpoint feeds the resume and the export
                    shutil.rmtree(f"{root}/{out_dir}/ckpt")
                torch.cuda.empty_cache()
        finally:
            TC.to_host, TC._write, TC.load_checkpoint = real["to_host"], real["_write"], real["load_checkpoint"]
        res["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    parity, resume = runs["parity"], runs["resume"]
    assert parity["epochs_run"] == 1 and [h["epoch"] for h in parity["history"]] == [0]
    assert [h["epoch"] for h in resume["history"]] == [1], "the resumed run must start at epoch 1"
    for run, r in runs.items():
        for h in r["history"]:
            assert h["steps"] == TRAIN_N // TRAIN_BATCH and all(np.isfinite(v) for v in h["train"].values()), (run, h)
            assert {"T2I_MRR", "T2T_MRR"} <= set(h["val"]), (run, h["val"])
    assert "loss_d256" in runs["variant2"]["history"][0]["train"]
    lines = open(f"{root}/parity/train_metrics.jsonl").read().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0, 1], lines  # parity's epoch, then the resume's
    step_ms = {run: tally.step_ms(run) for run in runs}
    paths = {
        "training forward, image tower (s=257)": tally.count(("parity", "resume", "variant2"), "train", "image"),
        "training forward, text towers (s=77)": tally.count(runs, "train", "text"),
        "validation, both towers": sum(tally.count(runs, "validation", t) for t in ("image", "text")),
        "FLIP run (ratio 0.5), image tower (s=129)": tally.count(("variant",), "train", "image"),
        "remat recompute in the backward": tally.count(("variant",), "train", "step")
        - sum(tally.count(("variant",), "train", t) for t in ("image", "text")),
    }
    for path, n in paths.items():
        assert n > 0, f"B6 never launched on {path}"
    res.update(
        runs={r: dict(wall_s=v["wall_s"], epoch_s=[h["epoch_time_s"] for h in v["history"]],
                      loss=[h["train"]["loss"] for h in v["history"]], best=v["best_metric"]) for r, v in runs.items()},
        step_ms={r: float(np.median(v)) for r, v in step_ms.items() if v}, ckpt_timing=timing)
    log(f"train runs (cli.train, {variant_arch}, batch {TRAIN_BATCH}, synthetic:{TRAIN_N}): " + "; ".join(
        f"{r} {v['wall_s']:.1f} s, epochs {', '.join(f'{e:.1f}' for e in v['epoch_s'])} s, loss "
        f"{', '.join(f'{x:.4f}' for x in v['loss'])}, step ms (events, median of steps 2..n) "
        f"{res['step_ms'].get(r, float('nan')):.1f}" for r, v in res["runs"].items()))
    log(f"train checkpoints: {res['ckpt_bytes'] / 1e9:.2f} GB (EMA run {res['ema_ckpt_bytes'] / 1e9:.2f} GB); "
        f"snapshot s {[round(x, 2) for x in timing['snapshot_s']]}; write s {[round(x, 2) for x in timing['write_s']]}; "
        f"load s {[round(x, 2) for x in timing['load_s']]}; max_memory_allocated "
        f"{res['max_memory_allocated'] / 2**30:.2f} GiB; B6 launches {paths}")

    wall["cli.train runs"] = time.perf_counter() - t_runs
    # export the best checkpoint, load it back, serve it
    t_export = t0 = time.perf_counter()
    pt = EX.main([f"--model.name={variant_arch}", "--train-dir", f"{root}/parity/ckpt", "--role=best", "--format=openai",
                  "--out", f"{root}/trained.pt"])
    export_s = time.perf_counter() - t0
    sd = load_clip_state_dict(pt)
    want = EX.module_to_openai(TC.load_params_only(f"{root}/parity/ckpt", "best"))
    assert set(sd) == set(want) and all(np.array_equal(sd[k], want[k].reshape(sd[k].shape)) for k in want)
    del want
    shutil.rmtree(f"{root}/parity/ckpt")
    model = load_openai_state_dict(sd, device=dev, dtype=torch.bfloat16)
    del sd
    tok = CLIPTokenizer(MERGES)
    rng = np.random.default_rng(23)
    words = ["cat", "hel", "hello", "ca", "he"]
    queries = [" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)]
    ids = torch.from_numpy(tok(queries, context_length=77)).to(dev)
    images = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, 224, 224, 3)).astype(np.float32)).to(dev)
    with torch.no_grad():
        cos_t = torch.nn.functional.cosine_similarity(
            model.encode_text(ids), FE.encode_text_fast(model.arch, FE.make_text_plan(model), ids), dim=-1).min().item()
        cos_i = torch.nn.functional.cosine_similarity(
            model.encode_image(images), FE.encode_image_fast(model.arch, FE.make_vision_plan(model), images),
            dim=-1).min().item()
    log(f"trained model exported ({export_s:.1f} s) and loaded: module towers vs fast, min cosine text {cos_t:.6f}, "
        f"image {cos_i:.6f}")
    assert cos_t > STORE_COS and cos_i > STORE_COS, (cos_t, cos_i)
    retriever = CLIPRetrieval(model, tok, EmbeddingStore.load(store_path), device=dev, top_k=K,
                              use_fused_encoder=True, corpus_dtype=torch.bfloat16)
    retriever.search_batch(queries[:8])
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    vals, idx = retriever.search_batch(queries)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    served = dispatch.launch_counts()
    assert vals.shape == (QUERIES, K) and bool(torch.isfinite(vals.float()).all())
    for name in ("fused_attention_block", "fused_mlp_block", "similarity_topk_kernel"):
        assert served[name] > 0, f"{name} never launched serving the trained model"
    log(f"trained model served (fast, {QUERIES} queries over {CORPUS} rows): {serve_ms:.2f} ms, launches "
        f"{ {k: v for k, v in served.items() if v} }")
    res.update(export_s=export_s, cos_text=cos_t, cos_image=cos_i, serve_ms=serve_ms)
    del retriever, model
    torch.cuda.empty_cache()
    wall["export, load, serve"] = time.perf_counter() - t_export

    # a seeded ViT-L/14 on one fixed batch, 8 steps at a raised lr: the loss must fall
    t0 = time.perf_counter()
    model = copy.deepcopy(seeded)  # the weights CM.build_model("ViT-L/14", seed=0) draws
    cfg = TrainConfig(batch_size=TRAIN_BATCH, lr=OVERFIT_LR, epochs=1)
    pipe = DataPipeline(make_synthetic_source(TRAIN_BATCH, image_size=224), CLIPTokenizer([]), context_length=77)
    state = TT.TrainState(model, TT.make_optimizer(cfg, 1, model))
    step = TT.make_train_step(model, cfg)
    host = pipe.make_batch(list(range(TRAIN_BATCH)))
    batch = {k: torch.from_numpy(getattr(host, k)).to(dev) for k in ("images", "query_ids", "target_ids")}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(OVERFIT_STEPS)]
    log(f"train overfit check (one batch, lr {OVERFIT_LR:g}, {OVERFIT_STEPS} steps): losses {[round(x, 4) for x in losses]}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    res["overfit_losses"] = losses
    del model, state, step
    torch.cuda.empty_cache()
    wall["overfit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _card_vs_cpu_steps(torch, dev, results)
    wall["card vs CPU"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bench = {}
    for remat in (False, True):
        e = TB.run_entry("ViT-L/14", TRAIN_BATCH, remat, TRAIN_BENCH_STEPS, dev)
        bench[f"remat={remat}"] = {k: e[k] for k in ("step_ms", "device_ms", "samples_per_s", "mfu", "mfu_device",
                                                    "max_memory_allocated", "flops_per_step")}
    res["train_bench"] = bench
    wall["train_bench"] = time.perf_counter() - t0
    log("train_bench ViT-L/14 batch 64: " + "; ".join(
        f"{k} step {v['step_ms']:.1f} ms (device {v['device_ms']:.1f}), {v['samples_per_s']:.1f} samples/s, MFU "
        f"{v['mfu']:.3f} (device {v['mfu_device']:.3f}), {v['flops_per_step'] / 1e12:.1f} TFLOP a step, peak "
        f"{v['max_memory_allocated'] / 2**30:.1f} GiB" for k, v in bench.items()))
    shutil.rmtree(root)
    del CM.ARCHS[variant_arch]
    res["phase_s"] = time.perf_counter() - t_phase
    res["wall_s"] = wall
    log(f"train phase: {res['phase_s']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in wall.items())})")
    return paths


# -- item 23: the training variants (ROADMAP A4 b) --

LORA_RANK, MINE_K, NEG_K, GC_CHUNKS = 8, 16, 4, 4
QAT_PAYOFF_EPOCHS = 3  # scripts/qat_payoff.py's run here (its default 12)
# QAT's loss, card against CPU: its forward rounds ~5e7 activations to int8 steps, and the products feeding them
# sum in another order on each device, so the few that sit within f32 noise of a rounding boundary round either
# way; each such flip moves an activation by a whole step (measured on an H100: 2.8e-4 relative at ViT-L/14 widths
# x 2 layers, batch 8). The updated tensors and the gradients' cosine keep their f32 bounds.
TOL_QAT_LOSS = 1e-3
# card merge against the host merge: half a bf16 step, relative, and f32 noise where W + s (a @ b)ᵀ nearly cancels
TOL_MERGE, TOL_MERGE_ABS = 2.0 ** -9, 1e-7


def _variant_card_vs_cpu_steps(torch, dev, res):
    """ViT-L/14 widths at 1 layer a tower, batch 4, f32: one LoRA (all
    targets), one QAT, one GradCache (2 chunks) and one distill (768-d teacher
    rows, cosine term on) step on the card against the CPU (plain versions):
    losses (QAT's to ``TOL_QAT_LOSS``) and the updated tensors to 1e-4, the
    gradient cosine per tensor.
    Returns {variant: B6 launches on the card}."""
    import dataclasses

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import lora as TL
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.distill import make_distill_step
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    arch = dataclasses.replace(CM.ARCHS["ViT-L/14"], vision_layers=TRAIN_SMALL_LAYERS, text_layers=TRAIN_SMALL_LAYERS)
    pipe = DataPipeline(make_synthetic_source(TRAIN_SMALL_BATCH, image_size=arch.image_resolution, seed=5),
                        CLIPTokenizer([]), image_size=arch.image_resolution, context_length=arch.context_length)
    host = pipe.make_batch(list(range(TRAIN_SMALL_BATCH)))
    rng = np.random.default_rng(9)
    teacher = [rng.standard_normal((TRAIN_SMALL_BATCH, arch.embed_dim)).astype(np.float32) for _ in range(3)]
    teacher = [t / np.linalg.norm(t, axis=1, keepdims=True) for t in teacher]
    variants = {"lora": dict(lora_rank=LORA_RANK, lora_targets="all"), "qat": dict(qat=True),
                "gradcache": dict(grad_cache_chunks=2), "distill": dict(distill_embed_weight=0.5)}
    out, launches = {}, {}
    for name, kw in variants.items():
        cfg = TrainConfig(batch_size=TRAIN_SMALL_BATCH, **kw)
        runs = {}
        for where in (dev, torch.device("cpu")):
            model = CM.build_model("", arch=arch, dtype=torch.float32, seed=3, device=where)
            adapters = None
            if name == "lora":
                base = dict(model.named_parameters())
                for p in base.values():
                    p.requires_grad_(False)
                adapters = {n: torch.nn.Parameter(a) for n, a in
                            TL.lora_init(base, LORA_RANK, "all", torch.Generator().manual_seed(0)).items()}
                state = TT.TrainState(model, TT.Optimizer(adapters, cfg, 4), adapters=adapters)
                step = TT.make_train_step(model, cfg, adapters, cfg.lora_alpha / cfg.lora_rank)
            else:
                state = TT.TrainState(model, TT.make_optimizer(cfg, 4, model))
                step = (make_distill_step(model, cfg, arch.embed_dim, arch.embed_dim) if name == "distill"
                        else TT.make_train_step(model, cfg))
            grads = {}
            orig = state.optimizer.step
            state.optimizer.step = lambda g, orig=orig: (
                grads.update({k: v.detach().float().cpu().clone() for k, v in g.items()}), orig(g))
            batch = {k: torch.from_numpy(getattr(host, k)).to(where) for k in ("images", "query_ids", "target_ids")}
            if name == "distill":
                batch.update({k: torch.from_numpy(t).to(where) for k, t in zip(("t_img", "t_q", "t_t"), teacher)})
            if where == dev:
                torch.cuda.synchronize()
                dispatch.reset_launch_counts()
            _, m = step(state, batch)
            if where == dev:
                torch.cuda.synchronize()
                launches[name] = dispatch.launch_counts()["flash_attention_kernel"]
            trained = adapters if adapters is not None else dict(model.named_parameters())
            runs[where.type] = (float(m["loss"]), grads, {n: p.detach().float().cpu() for n, p in trained.items()})
            del model, state, step, adapters
        (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = runs[dev.type], runs["cpu"]
        tol_loss = TOL_QAT_LOSS if name == "qat" else TOL_F32
        assert np.isfinite(l_card) and abs(l_card - l_cpu) <= tol_loss * abs(l_cpu), (name, l_card, l_cpu)
        worst = max((float((p_card[n] - p_cpu[n]).abs().max()), n) for n in p_cpu)
        for n in p_cpu:
            np.testing.assert_allclose(p_card[n].numpy(), p_cpu[n].numpy(), rtol=TOL_F32, atol=TOL_F32,
                                       err_msg=f"{name} {n}")
        cos = {n: float(torch.nn.functional.cosine_similarity(g_card[n].flatten(), g_cpu[n].flatten(), dim=0))
               for n in g_cpu if g_cpu[n].abs().max() > 0}
        low = min(cos, key=cos.get)
        assert cos[low] >= TOL_GRAD_COS, (name, low, cos[low])
        out[name] = dict(loss=(l_card, l_cpu), max_tensor_diff=worst[0], grad_cos_min=cos[low], tensors=len(p_cpu))
        log(f"variant card vs CPU, {name}, f32, ViT-L/14 widths x {TRAIN_SMALL_LAYERS} layers, batch "
            f"{TRAIN_SMALL_BATCH}: loss {l_card:.6f} / {l_cpu:.6f}; {len(p_cpu)} updated tensors within {TOL_F32:g} "
            f"(max abs difference {worst[0]:.3g}, {worst[1]}); gradient cosine min {cos[low]:.6f} ({low}); B6 "
            f"launches {launches[name]}")
    res["card_vs_cpu"] = out
    return launches


def train_variants_phase(torch, dev, tmp, store_path, results):
    """The training variants through the port's entry points (item 23):
    every run at ViT-L/14 widths cut to ``TRAIN_VARIANT_LAYERS``: LoRA (rank
    8, all four block projections), batch 64, ``synthetic:128``, 2 epochs
    with validation, from a seeded ``.pt``; its
    adapters exported into the base (``cli.export --model.adapters``), the
    card's merge against the host's, the merged model served (one 256-query
    ``int8`` batch: B1, B2 q8) against the plain top-k; GradCache (4 chunks)
    and QAT at ``TRAIN_VARIANT_LAYERS``, 1 epoch each; mined
    negatives (``cli.mine_negatives --eval.encoder=int8 --k=16``: B1 on both
    towers; the card's table against a CPU mining of the same embeddings)
    and ``cli.train`` with them; ``cli.distill`` (ViT-B/32 student at full
    depth, an ``int8`` teacher); ``scripts/qat_payoff.py`` at 3 epochs (B1 in its int8
    deploy); and the card-vs-CPU variant steps. Returns {kernel line: {path:
    launches}}."""
    import dataclasses

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import distill as CD
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import export as EX
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import mine_negatives as MN
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train as CT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import evaluator as EV
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_clip_state_dict, save_openai_pt
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as SIM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import qat_payoff as QP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import lora as TL
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import negatives as TN
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT

    t_phase = time.perf_counter()
    res = results["train_variants"] = {}
    root = tempfile.mkdtemp(dir=tmp)
    dev_flag = f"--device={dev.type}"
    variant_arch = "ViT-L/14 ({} + {} layers)".format(*TRAIN_VARIANT_LAYERS)
    CM.ARCHS[variant_arch] = dataclasses.replace(CM.ARCHS["ViT-L/14"], vision_layers=TRAIN_VARIANT_LAYERS[0],
                                                 text_layers=TRAIN_VARIANT_LAYERS[1])
    wall, counts, peak = {}, {}, {}

    def counted(path, fn):
        """Run one path with the launch counts set to 0 just before and read just after."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[path], counts[path] = time.perf_counter() - t0, dispatch.launch_counts()
        peak[path] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
        return out

    def train_argv(run, name, *extra):
        return [dev_flag, f"--model.name={name}", f"--data.dataset=synthetic:{TRAIN_N}",
                f"--train.batch_size={TRAIN_BATCH}", f"--eval.output_dir={root}/{run}",
                f"--train.checkpoint_dir={root}/{run}/ckpt", *extra]

    runs = {}
    base_pt = f"{root}/base.pt"
    t0 = time.perf_counter()
    save_openai_pt(CM.build_model(variant_arch, dtype=torch.float32, seed=0), base_pt)  # the seeded base, on the host
    res["base_pt_s"] = wall["base .pt"] = time.perf_counter() - t0
    with _LaunchTally(torch, CM, TT, dispatch) as tally:
        for run, name, extra in (
            ("lora", variant_arch, [f"--model.checkpoint={base_pt}", f"--train.lora_rank={LORA_RANK}",
                                  "--train.lora_targets=all", "--train.epochs=2"]),
            ("gradcache", variant_arch, [f"--train.grad_cache_chunks={GC_CHUNKS}", "--train.epochs=1"]),
            ("qat", variant_arch, ["--train.qat=true", "--train.epochs=1"]),
        ):
            tally.run = run
            runs[run] = counted(run, lambda: CT.main(train_argv(run, name, *extra)))
            if run != "lora":
                shutil.rmtree(f"{root}/{run}/ckpt")

        # mined negatives: the int8 towers encode the split, the card mines, the CPU mines the same embeddings
        mined = {}

        def mine(anchors, candidates, k, **kw):
            mined.update(anchors=np.asarray(anchors), candidates=np.asarray(candidates))
            mined["table"] = real_mine(anchors, candidates, k, **kw)
            return mined["table"]

        real_mine, MN.mine_hard_negatives = MN.mine_hard_negatives, mine
        try:
            with _Tally([(EV, "encode_image_fast"), (EV, "encode_text_fast")]) as mine_tally:
                neg_path = counted("mine", lambda: MN.main([
                    dev_flag, f"--model.name={variant_arch}", f"--data.dataset=synthetic:{TRAIN_N}", "--eval.encoder=int8",
                    f"--k={MINE_K}", f"--out={root}/negatives.npz"]))
        finally:
            MN.mine_hard_negatives = real_mine
        table, uuids = TN.load_negatives(neg_path)
        assert table.shape == (TRAIN_N, MINE_K) and np.array_equal(table, mined["table"]) and len(uuids) == TRAIN_N
        # the CPU mines the same embeddings; the two products sum in another order, so two candidates within
        # NEAR_TIE of each other (equal texts give equal rows: ties) may order either way on the card
        cpu_table = TN.mine_hard_negatives(mined["anchors"], mined["candidates"], MINE_K, device="cpu")
        scores = torch.from_numpy(mined["anchors"]) @ torch.from_numpy(mined["candidates"]).T
        scores.fill_diagonal_(float("-inf"))
        top = torch.sort(scores, dim=1, descending=True).values[:, : MINE_K + 1]
        near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(dim=1).numpy()
        differ = (table != cpu_table).any(axis=1)
        assert not (differ & ~near).any(), f"card mining differs from the CPU's on rows {np.flatnonzero(differ & ~near)[:5]}"
        picked = torch.take_along_dim(scores, torch.from_numpy(table).long(), dim=1)
        topk_agree((picked, torch.from_numpy(table)), scores, MINE_K, NEAR_TIE)  # every row a top-k, ties aside
        res["mining"] = dict(rows=TRAIN_N, k=MINE_K, near_tie_rows=int(near.sum()), differing_rows=int(differ.sum()))
        log(f"variants: cli.mine_negatives ({variant_arch} int8, synthetic:{TRAIN_N}, k {MINE_K}) {wall['mine']:.1f} s; "
            f"the card's table equals the CPU's on the {int((~near).sum())} rows without a near tie and is a top-{MINE_K} "
            f"of the CPU's scores within {NEAR_TIE:g} on all {TRAIN_N} ({int(differ.sum())} of the {int(near.sum())} "
            f"near-tie rows order otherwise)")
        tally.run = "negatives"
        runs["negatives"] = counted("negatives", lambda: CT.main(train_argv(
            "negatives", variant_arch, f"--train.hard_negatives={neg_path}", f"--train.hard_negatives_k={NEG_K}",
            "--train.epochs=1")))
        shutil.rmtree(f"{root}/negatives/ckpt")

        # distillation: the ViT-L/14 int8 teacher encodes the split, a ViT-B/32 student trains
        tally.run = "distill"
        with _Tally([(EV, "encode_image_fast"), (EV, "encode_text_fast")]) as teacher_tally:
            runs["distill"] = counted("distill", lambda: CD.main([
                dev_flag, "--model.name=ViT-B/32", f"--teacher-name={variant_arch}", "--teacher-encoder=int8",
                "--train.distill_embed_weight=0", f"--data.dataset=synthetic:{TRAIN_N}",
                f"--train.batch_size={TRAIN_BATCH}", "--train.epochs=1", f"--eval.output_dir={root}/distill",
                f"--train.checkpoint_dir={root}/distill/ckpt"]))
        shutil.rmtree(f"{root}/distill/ckpt")
        step_ms = {run: tally.step_ms(run) for run in runs}
        b6_train = {run: tally.count((run,), "train", "step") for run in runs}
        b6_val = {run: sum(tally.count((run,), "validation", t) for t in ("image", "text")) for run in runs}
    for run, r in runs.items():
        for h in r["history"]:
            assert h["steps"] == TRAIN_N // TRAIN_BATCH and all(np.isfinite(v) for v in h["train"].values()), (run, h)
            assert {"T2I_MRR", "T2T_MRR"} <= set(h["val"]), (run, h["val"])
    assert runs["lora"]["epochs_run"] == 2 and set(runs["distill"]["history"][0]["train"]) >= {"loss_kd", "loss_embed"}

    # the LoRA artifact: exported into the base, merged on the card against the host, served
    ad_path = runs["lora"]["adapters_path"]
    adapters, meta = TL.load_adapters(ad_path, device=dev)
    assert meta == {"rank": LORA_RANK, "alpha": 16.0, "targets": "all", "model": variant_arch}
    res["lora"] = dict(adapter_params=TL.lora_param_count(adapters), adapter_file_bytes=os.path.getsize(ad_path))
    t0 = time.perf_counter()
    merged_pt = EX.main([f"--model.name={variant_arch}", f"--model.checkpoint={base_pt}", f"--model.adapters={ad_path}",
                         "--format=openai", "--out", f"{root}/merged.pt"])
    res["lora"]["export_s"] = time.perf_counter() - t0
    base_sd, merged_sd = load_clip_state_dict(base_pt), load_clip_state_dict(merged_pt)
    host = TL.lora_merge_host(base_sd, {k: v.cpu().numpy() for k, v in adapters.items()}, TL.adapter_scale(meta))
    assert set(merged_sd) == set(host) and all(np.array_equal(merged_sd[k], host[k]) for k in host)
    worst = 0.0
    for name in TL.adapted_names(adapters):
        key = TL.openai_key(name)
        card = (torch.from_numpy(base_sd[key]).to(dev) + TL.lora_delta(adapters, name, TL.adapter_scale(meta))).cpu()
        want = torch.from_numpy(host[key])
        rel = float(((card - want).abs() / want.abs().clamp_min(1e-30)).max())
        assert bool(((card - want).abs() <= TOL_MERGE * want.abs() + TOL_MERGE_ABS).all()), (name, rel)
        worst = max(worst, float((card - want).abs().max()))
    moved = max(float(np.abs(host[k] - base_sd[k]).max()) for k in host)
    assert moved > 0, "the adapters left the base unchanged"
    res["lora"].update(merge_max_abs_diff=worst, merged_max_change=moved)
    del base_sd, host
    model = load_openai_state_dict(merged_sd, device=dev, dtype=torch.bfloat16)
    del merged_sd
    tok = CLIPTokenizer(MERGES)
    rng = np.random.default_rng(29)
    words = ["cat", "hel", "hello", "ca", "he"]
    queries = [" ".join(rng.choice(words, size=rng.integers(4, 12))) for _ in range(QUERIES)]
    retriever = CLIPRetrieval(model, tok, EmbeddingStore.load(store_path), device=dev, top_k=K, use_fused_encoder=True,
                              quantize="int8", quantize_corpus="int8")
    retriever.search_batch(queries[:8])
    got = counted("lora serve", lambda: retriever.search_batch(queries))
    c = retriever._corpus
    q = retriever.encode_queries(queries)
    topk_agree(retriever._score(c, q, 0.5, K), SIM.blended_scores_q8(
        q.to(torch.bfloat16), c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, 0.5), K, TOL_TOPK)
    assert got[0].shape == (QUERIES, K) and bool(torch.isfinite(got[0].float()).all())
    log(f"variants: LoRA (rank {LORA_RANK}, all) adapters {res['lora']['adapter_params']} parameters, "
        f"{res['lora']['adapter_file_bytes']} bytes; cli.export --model.adapters {res['lora']['export_s']:.1f} s; "
        f"card merge within {TOL_MERGE:g} relative of the host merge (max abs difference {worst:.3g}; the adapters "
        f"moved a weight by up to {moved:.3g}); the merged model served int8 ({QUERIES} queries over {CORPUS} rows) "
        f"in {wall['lora serve'] * 1e3:.2f} ms, top-k == plain top-k")
    del retriever, model
    torch.cuda.empty_cache()

    payoff = counted("qat_payoff", lambda: QP.main([dev_flag, f"--epochs={QAT_PAYOFF_EPOCHS}"]))
    for run in ("ptq", "qat"):
        assert all(np.isfinite(v) for v in payoff["runs"][run].values()), payoff["runs"][run]
    res["qat_payoff"] = dict(payoff["runs"], delta=payoff["delta_qat_minus_ptq"], wall_s=wall["qat_payoff"])
    log(f"variants: scripts/qat_payoff.py ({QAT_PAYOFF_EPOCHS} epochs) {wall['qat_payoff']:.1f} s: {payoff['runs']}; "
        f"delta {payoff['delta_qat_minus_ptq']}")

    t0 = time.perf_counter()
    card_vs_cpu = _variant_card_vs_cpu_steps(torch, dev, res)
    wall["card vs CPU"] = time.perf_counter() - t0
    shutil.rmtree(root)

    res.update(
        runs={r: dict(wall_s=wall[r], epoch_s=[h["epoch_time_s"] for h in v["history"]],
                      loss=[h["train"]["loss"] for h in v["history"]], best=v["best_metric"],
                      max_memory_allocated=peak[r]) for r, v in runs.items()},
        step_ms={r: float(np.median(v)) for r, v in step_ms.items() if v}, wall_s=wall)
    log("variants runs (batch {}, synthetic:{}): ".format(TRAIN_BATCH, TRAIN_N) + "; ".join(
        f"{r} {v['wall_s']:.1f} s, step ms (events, median of steps 2..n) {res['step_ms'].get(r, float('nan')):.1f}, "
        f"peak {v['max_memory_allocated'] / 2**30:.2f} GiB, loss {', '.join(f'{x:.4f}' for x in v['loss'])}"
        for r, v in res["runs"].items()))
    cut = "{} + {} layers".format(*TRAIN_VARIANT_LAYERS)
    what = {"lora": f"LoRA, {cut}", "gradcache": f"GradCache, {cut}, both passes", "qat": f"QAT, {cut}",
            "negatives": f"mined negatives, {cut}", "distill": "distill, ViT-B/32 student (s = 50)"}
    paths = {
        "B6 flash_attention s=257": {
            **{f"variants: {what[r]}: train steps": n for r, n in b6_train.items()},
            **{f"variants: {what[r]}: validation": n for r, n in b6_val.items()},
            "variants: qat_payoff training (width 64)": counts["qat_payoff"]["flash_attention_kernel"],
            **{f"variants: card-vs-CPU {v} step": n for v, n in card_vs_cpu.items()}},
        "B1 fused_layer_q8": {
            "variants: LoRA-merged int8 served batch": counts["lora serve"]["fused_layer_q8"],
            "variants: cli.mine_negatives int8 text tower": mine_tally.of("encode_text_fast", "fused_layer_q8"),
            "variants: cli.distill int8 teacher text tower": teacher_tally.of("encode_text_fast", "fused_layer_q8"),
            "variants: qat_payoff int8 deploy (width 64, both towers)": counts["qat_payoff"]["fused_layer_q8"]},
        f"B1 fused_layer_q8 vision [{V_BATCH}x{V_SEQ}]": {
            "variants: cli.mine_negatives int8 image tower": mine_tally.of("encode_image_fast", "fused_layer_q8"),
            "variants: cli.distill int8 teacher image tower": teacher_tally.of("encode_image_fast", "fused_layer_q8")},
        "B2 similarity_topk q8": {"variants: LoRA-merged int8 served batch": counts["lora serve"]["similarity_topk_kernel"]},
    }
    for line, by in paths.items():
        for path, n in by.items():
            assert n > 0, f"{line} never launched on {path}"
    res["launches_by_path"] = paths
    del CM.ARCHS[variant_arch]
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"train variants phase: {res['phase_s']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in wall.items())})")
    return paths


PT_SHARDS = 4  # the parallel training phase's mesh: [cuda:0] * 4
PT_BATCH, PT_FULL_BATCH = 16, 64  # the equality steps' batch (4 rows a shard), the full-depth steps' batch
PT_MP_N, PT_MP_BATCH = 16, 8  # the two-process cli.train run: synthetic:16, 2 steps an epoch, 2 epochs
TOL_PT_LOSS, TOL_PT_PARAM = 1e-5, 2e-5  # a sharded step against one device (JAX tests/test_{fsdp,tp}.py)
TOL_PT_NORM = 1e-5  # a sharded step's grad_norm against one device's, relative
# The equality steps' learning rate. AdamW's first step moves each parameter by about lr * sign(g), so a gradient
# that is wrong in sign or never arrives moves it by lr or more: 10x TOL_PT_PARAM. Where |g| is under AdamW's eps
# (1e-6) the step is lr * g / eps, which turns f32 rounding in g (~2e-8 at these widths: dp2 x tp2's split sums)
# into lr * 2e-2: 4e-6 here, 2e-5 (the limit) at lr 1e-3.
PT_LR = 2e-4
PT_MP_LR = 1e-3  # the two-process run's (the CPU tests'): 4 steps of DP, whose sums split only the batch
TOL_PT_MP = 1e-4  # two processes' parameters (and monitors) after 4 steps against one process (the repo's fp bar)
TOL_PT_FSDP_STATE = 0.01  # FSDP's state bytes a position against a quarter of the replicated state
TOL_PT_BLOCKS = 1e-4  # pp / sp blocks against the stack or the module (f32, the kernel's order of sums)
# the full-depth steps in the run where the GSPMD step built the whole model on each device row once a step
# (medians, CUDA events, NVIDIA H100 80GB HBM3 at 700 W): read beside the steps that build one unit at a time
PT_EARLIER_MS = {"dp4": 650.0, "fsdp4": 860.0, "dp2xtp2": 525.6}
PT_LAYOUTS = {"dp4": dict(data_parallel=4), "fsdp4": dict(data_parallel=4, fsdp=True),
              "dp2xtp2": dict(data_parallel=2, model_parallel=2),
              "fsdp2xtp2": dict(data_parallel=2, model_parallel=2, fsdp=True),
              "dcn2xdp2": dict(dcn_parallel=2, data_parallel=2)}
_MP_TRAIN = """
import sys, torch
import chip_smoke
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train as CT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
real = TT.CLIPTrainer.train
def train(self, *a, **kw):  # keep each rank's final parameters beside the result
    out = real(self, *a, **kw)
    torch.save({"params": self.params(), "result": out}, sys.argv[1])
    return out
TT.CLIPTrainer.train = train
CT.main(sys.argv[2:])
chip_smoke.pp_sp_ep_across_processes(sys.argv[1] + ".pp_sp_ep.json")  # the ranks' gloo group is still up
"""
PPX_STAGES, PPX_MICRO, PPX_MB = 4, 8, 8  # pp across processes: 4 stages, 8 microbatches of [8, 77, 768]
SP_SEQ = 1024  # the ring's and the sequence-parallel block's sequence
TOL_PT_BF16 = 2e-2  # the bf16 ring against mha (tests/test_torch_pp_sp_ep.py)


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def pp_sp_ep_across_processes(out_path: str) -> None:
    """Run in each of the two ``cli.train`` ranks of ``parallel_training_phase``
    (3) after training, over their gloo group, every rank on ``cuda:0``:
    pipeline, sequence and expert parallelism with the axis across the two
    processes (case A: ``[cuda:0] * 2`` a rank, four positions; the sp block
    ``[cuda:0]`` a rank, two) and with ``data`` across them (case B, dp2 x
    pp2). Each rank's inputs are NaN in the rows it must not read (other
    ranks' stages, sequence shards, experts). At ViT-L/14's text widths:
    pp (12 blocks, 4 stages, 8 microbatches of [8, 77, 768]) forward and
    gradients against the one-process ``pipeline_apply`` over ``[cuda:0] * 4``
    and the sequential stack; dp2 x pp2 against the stack; ``ring_attention``
    [2, 12, 1024, 64] f32 causal against ``mha`` (B7) and its gradients
    against the one-process ring, bf16 against ``mha``; ``sp_block_apply``
    at s = 1024 against ``ResidualBlock`` and its gradients against one
    process; ep (4 experts, 768 / 3072, 154 tokens) against the unsharded
    call. Writes each check's errors, wall s, the hops' log and B6 / B7
    launches to ``out_path``; raises on any disagreement."""
    import torch
    import torch.distributed as dist

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.attention import mha
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import ep as EP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import pp as PP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import sp as SP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh, axis_row
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.sharding import hop_log

    rank, world = dist.get_rank(), dist.get_world_size()
    on_card = torch.cuda.is_available()
    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    flash = "flash_attention_kernel"
    arch = CM.ARCHS["ViT-L/14"]
    width, heads, layers = arch.text_width, arch.text_heads, arch.text_layers  # 768, 12, 12
    rng = np.random.default_rng(17)
    report = {"rank": rank, "checks": {}, "launches": {}}

    def mesh(axes, local, across=True):
        arr = np.empty(int(np.prod(local)), dtype=object)
        arr[:] = [dev] * arr.size
        if across:
            return Mesh(arr.reshape(local), axes, process_index=rank, process_count=world, group=dist.group.WORLD)
        return Mesh(arr.reshape(local), axes)

    def f32(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def poisoned(x, dim, per, positions):
        """``x`` with NaN in the slices of dim ``dim`` that ``positions`` do not own, as a leaf."""
        x = x.detach().clone()
        for j in range(x.shape[dim] // per):
            if j not in positions:
                x.narrow(dim, j * per, per).fill_(float("nan"))
        return x.requires_grad_()

    def rows_agree(tag, got, want, dim, per, positions, tol):
        """The owned slices within ``tol`` (relative), the others exactly zero."""
        err = 0.0
        for j in range(got.shape[dim] // per):
            g, w = got.narrow(dim, j * per, per), want.narrow(dim, j * per, per)
            if j in positions:
                err = max(err, _rel(g, w))
            else:
                assert not g.any(), f"{tag}: a gradient in rows rank {rank} does not own"
        assert err <= tol, f"{tag}: {err}"
        return err

    def check(name, fn):
        sync()
        hop_log.reset()
        t0 = time.perf_counter()
        out = fn()
        sync()
        report["checks"][name] = dict(out, wall_s=time.perf_counter() - t0, hops=hop_log.snapshot())

    shapes = {k: tuple(v.shape) for k, v in CM.ResidualBlock(width, heads).state_dict().items()}
    blocks = [{k: (1 + f32(sh, 0.02) if k.startswith("ln_") and k.endswith("weight") else
                   f32(sh, 0.02 if k.endswith("weight") else 0.01)) for k, sh in shapes.items()}
              for _ in range(layers)]
    block = CM.ResidualBlock(width, heads).to(dev)
    layer = lambda p, x: torch.func.functional_call(block, p, (x, True))  # noqa: E731
    xs, w = f32((PPX_MICRO, PPX_MB, 77, width)), f32((PPX_MICRO, PPX_MB, 77, width))
    # the sequential stack: the references of both pp layouts
    seq_blocks = [{k: v.clone().requires_grad_() for k, v in b.items()} for b in blocks]
    seq_xs = xs.clone().requires_grad_()
    want = []
    for mb in range(PPX_MICRO):
        h = seq_xs[mb]
        for p in seq_blocks:
            h = layer(p, h)
        want.append(h)
    want = torch.stack(want)
    (want * w).sum().backward()

    def pp_case(stages, cross_mesh, one_mesh):
        row = axis_row(cross_mesh, "pipe")
        stacked = PP.stack_stages(blocks, stages)
        mine = {k: poisoned(v, 0, 1, row.positions) for k, v in stacked.items()}
        x_r = xs.clone().requires_grad_()
        dispatch.reset_launch_counts()
        got = PP.pipeline_apply(layer, mine, x_r, cross_mesh, "pipe")
        (got * w).sum().backward()
        sync()
        launches = dispatch.launch_counts()[flash]
        g_seq = PP.stack_stages([{k: v.grad for k, v in b.items()} for b in seq_blocks], stages)
        out = dict(forward_vs_stack=_rel(got, want), xs_grad_vs_stack=_rel(x_r.grad, seq_xs.grad),
                   grads_vs_stack=max(rows_agree(f"pp {k}", mine[k].grad, g_seq[k], 0, 1, row.positions,
                                                 TOL_PT_BLOCKS) for k in mine), b6_launches=launches,
                   positions=row.positions)
        if one_mesh is not None:
            one = {k: v.clone().requires_grad_() for k, v in stacked.items()}
            x1 = xs.clone().requires_grad_()
            t0 = time.perf_counter()
            got1 = PP.pipeline_apply(layer, one, x1, one_mesh, "pipe")
            (got1 * w).sum().backward()
            sync()
            out.update(one_process_s=time.perf_counter() - t0, forward_vs_one_process=_rel(got, got1),
                       grads_vs_one_process=max(rows_agree(f"pp {k} (one process)", mine[k].grad, one[k].grad, 0, 1,
                                                           row.positions, TOL_PT_BLOCKS) for k in mine))
        assert out["forward_vs_stack"] <= TOL_PT_BLOCKS and out["xs_grad_vs_stack"] <= TOL_PT_BLOCKS, out
        assert out.get("forward_vs_one_process", 0.0) <= TOL_PT_BLOCKS, out
        return out

    check("pp across processes", lambda: pp_case(PPX_STAGES, mesh(("pipe",), (2,)), mesh(("pipe",), (4,), False)))
    check("dp2 x pp2", lambda: pp_case(2, mesh(("data", "pipe"), (1, 2)), None))
    report["launches"]["pp across processes"] = report["checks"]["pp across processes"]["b6_launches"]
    report["launches"]["dp2 x pp2"] = report["checks"]["dp2 x pp2"]["b6_launches"]
    del seq_blocks, want

    def ring_case():
        cross = mesh(("seq",), (2,))
        row, per = axis_row(cross, "seq"), SP_SEQ // 4
        out = {}
        for dt, tol in ((torch.float32, TOL_PT_BLOCKS), (torch.bfloat16, TOL_PT_BF16)):
            q, k, v = (f32((2, heads, SP_SEQ, 64)).to(dt) for _ in range(3))
            mq, mk, mv = (poisoned(t, 2, per, row.positions) for t in (q, k, v))
            got = SP.ring_attention(mq, mk, mv, cross, causal=True)
            dispatch.reset_launch_counts()
            with torch.no_grad():
                dense = mha(q, k, v, causal=True)
            sync()
            report["launches"][f"sp dense reference {str(dt)[6:]}"] = dispatch.launch_counts()[flash]
            err = float((got.float() - dense.float()).abs().max())
            assert err <= tol, f"ring attention {dt}: {err}"
            out[f"{str(dt)[6:]} vs mha"] = err
            if dt == torch.float32:
                g = f32(got.shape)
                (got * g).sum().backward()
                one = [t.clone().requires_grad_() for t in (q, k, v)]
                (SP.ring_attention(*one, mesh(("seq",), (4,), False), causal=True) * g).sum().backward()
                out["f32 grads vs one process"] = max(rows_agree(f"ring d{n}", a.grad, b.grad, 2, per, row.positions,
                                                                 TOL_PT_BLOCKS) for n, a, b in zip("qkv", (mq, mk, mv), one))
        return out

    check("ring_attention", ring_case)

    def block_case():
        cross = mesh(("seq",), (1,))
        row, per = axis_row(cross, "seq"), SP_SEQ // 2
        x = f32((2, SP_SEQ, width))
        params = {k: v.clone().requires_grad_() for k, v in blocks[0].items()}
        mx = poisoned(x, 1, per, row.positions)
        got = SP.sp_block_apply(params, mx, cross, heads=heads, causal=True)
        dispatch.reset_launch_counts()
        with torch.no_grad():
            dense = layer(blocks[0], x)
        sync()
        report["launches"]["sp block reference"] = dispatch.launch_counts()[flash]
        g = f32(got.shape)
        (got * g).sum().backward()
        one_p = {k: v.clone().requires_grad_() for k, v in blocks[0].items()}
        one_x = x.clone().requires_grad_()
        (SP.sp_block_apply(one_p, one_x, mesh(("seq",), (2,), False), heads=heads, causal=True) * g).sum().backward()
        out = {"forward vs ResidualBlock": _rel(got, dense),
               "x grad vs one process": rows_agree("sp block dx", mx.grad, one_x.grad, 1, per, row.positions,
                                                   TOL_PT_BLOCKS),
               "param grads vs one process": max(_rel(params[k].grad, one_p[k].grad) for k in params)}
        assert out["forward vs ResidualBlock"] <= TOL_PT_BLOCKS and out["param grads vs one process"] <= TOL_PT_BLOCKS, out
        return out

    check("sp_block_apply", block_case)

    def ep_case():
        cross = mesh(("expert",), (2,))
        row = axis_row(cross, "expert")
        moe = EP.init_moe_params(torch.Generator().manual_seed(1), width, 4 * width, 4)
        x = f32((2, 77, width))
        g = f32(x.shape)
        mine = {n: poisoned(moe[n].to(dev), 0, 1, row.positions) for n in ("w_in", "b_in", "w_out", "b_out")}
        mine["router"] = {"kernel": moe["router"]["kernel"].to(dev).requires_grad_()}
        mx = x.clone().requires_grad_()
        y, aux = EP.moe_apply(mine, mx, k=2, mesh=cross)
        ((y * g).sum() + aux).backward()
        one = {n: moe[n].to(dev).requires_grad_() for n in ("w_in", "b_in", "w_out", "b_out")}
        one["router"] = {"kernel": moe["router"]["kernel"].to(dev).requires_grad_()}
        x1 = x.clone().requires_grad_()
        y1, aux1 = EP.moe_apply(one, x1, k=2)
        ((y1 * g).sum() + aux1).backward()
        out = {"forward vs unsharded": float((y - y1).abs().max()), "aux": abs(float(aux) - float(aux1)),
               "expert grads vs unsharded": max(rows_agree(f"ep {n}", mine[n].grad, one[n].grad, 0, 1, row.positions,
                                                           TOL_PT_BLOCKS) for n in ("w_in", "b_in", "w_out", "b_out")),
               "x / router grads vs unsharded": max(_rel(mx.grad, x1.grad),
                                                    _rel(mine["router"]["kernel"].grad, one["router"]["kernel"].grad))}
        assert out["forward vs unsharded"] <= TOL_PT_PARAM and out["aux"] <= 1e-5, out
        assert out["x / router grads vs unsharded"] <= TOL_PT_BLOCKS, out
        return out

    check("ep", ep_case)
    with open(out_path, "w") as f:
        json.dump(report, f)


def parallel_training_phase(torch, dev, tmp, model, results):
    """Parallel training (ROADMAP A5 (b), item 25) over ``[cuda:0] * 4``:
    (1) f32, TF32 off, ViT-L/14 widths at ``TRAIN_SMALL_LAYERS`` a tower,
    batch 16, global negatives: DP4, FSDP4, dp2 x tp2, fsdp + tp and dcn2 x
    dp2 against the one-device step (loss 1e-5, parameters 2e-5); DP4 with
    local negatives against the mean of the four shard losses computed by
    hand; LoRA, GradCache (2 chunks), distillation and mined negatives under
    DP4 against their one-device steps; (2) ViT-L/14 in bf16, batch 64: DP4,
    FSDP4 and dp2 x tp2, step ms (median of 3 after a warm-up), peak memory,
    finite losses, FSDP's state a position a quarter of the replicated one;
    FSDP4's peak below DP4's (FSDP builds one unit at a time and keeps only
    each block's input, recomputing the block in the backward; DP4 keeps
    each shard's activations and weight casts), the most FSDP4 held built
    at once (``ShardedParams.gauge``) no more than its largest unit; (3) two ``cli.train`` processes over gloo on the card (2 epochs of
    ``synthetic:16``) against one process over ``[cuda:0] * 2``, and one
    data-parallel step and encode under a world-size-1 NCCL group; (4) pp,
    sp and ep across the two ranks and dp2 x pp2 (``pp_sp_ep_across_processes``,
    run in each rank after ``cli.train``; its reports read here); (5) the sharded ``int8``
    encode over 4 shards against one device under the int8 rules. Returns
    {kernel line: {path: launches}}."""
    import copy
    import dataclasses

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval.evaluator import encode_dataset
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as FE
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import save_openai_pt
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.attention import mha
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import ep as EP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import pp as PP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import sp as SP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh, MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import distill as TD
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.lora import lora_init
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.losses import joint_contrastive_loss
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig, TrainConfig

    t_phase = time.perf_counter()
    res = results["parallel_training"] = {}
    wall, b6, pp_b6, paths = {}, {}, {}, {}
    flash = "flash_attention_kernel"
    tok = CLIPTokenizer(MERGES)

    def rt_of(layout, n=PT_SHARDS):
        return MeshRuntime.create(MeshConfig(**layout), [dev] * n)

    def host_batch(n, image_size=224):
        pipe = DataPipeline(make_synthetic_source(n, image_size=image_size), tok, image_size=image_size,
                            context_length=77, num_workers=4)
        b = pipe.make_batch(list(range(n)))
        return pipe, {"images": b.images, "query_ids": b.query_ids, "target_ids": b.target_ids}

    def on_dev(host):
        return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in host.items()}

    def whole(state, model):
        if state.layout is not None:
            return state.whole(state.params())
        if state.adapters is not None:
            return {n: a.detach() for n, a in state.adapters.items()}
        return {n: p.detach() for n, p in model.named_parameters()}

    def make(model, cfg, layout=None, adapters=None, distill=False):
        """(state, step) of one device (``layout`` None) or of a mesh layout."""
        rt = None if layout is None else rt_of(layout)
        if adapters is not None:
            ad = {n: torch.nn.Parameter(a.clone().to(dev)) for n, a in adapters.items()}
            for p in model.parameters():
                p.requires_grad_(False)
            state = TT.TrainState(model, TT.Optimizer(ad, cfg, 1), 0, None, ad)
            return state, TT.make_train_step(model, cfg, ad, cfg.lora_alpha / cfg.lora_rank, rt=rt)
        if distill:
            return TT.TrainState(model, TT.make_optimizer(cfg, 1, model)), TD.make_distill_step(
                model, cfg, model.arch.embed_dim, model.arch.embed_dim, rt=rt)
        if rt is not None and (rt.fsdp or rt.mesh.shape[rt.model_axis] > 1):
            state = (TT.init_state_fsdp if rt.fsdp else TT.init_state_gspmd)(model, cfg, rt, 1)
            return state, TT.make_train_step_gspmd(model, cfg, rt, state.layout)
        return TT.TrainState(model, TT.make_optimizer(cfg, 1, model)), TT.make_train_step(model, cfg, rt=rt)

    def compare(tag, base, cfg, host, layout, **kw):
        m1, m2 = copy.deepcopy(base), copy.deepcopy(base)
        s1, f1 = make(m1, cfg, **kw)
        s1, met1 = f1(s1, on_dev(host))
        s2, f2 = make(m2, cfg, layout, **kw)
        dispatch.reset_launch_counts()
        s2, met2 = f2(s2, dict(host))
        torch.cuda.synchronize()
        b6[tag] = dispatch.launch_counts()[flash]
        w1, w2 = whole(s1, m1), whole(s2, m2)
        start = dict(p0, **{n: t.detach() for n, t in (kw.get("adapters") or {}).items()})
        record(tag, met1, met2, max(float((w2[n].to(dev) - w1[n]).abs().max()) for n in w1),
               max(float((w1[n] - start[n].to(dev)).abs().max()) for n in w1))

    def record(tag, met1, met2, d_param, moved):
        """Hold a sharded step (``met2``) to the one-device step: loss, grad_norm, parameters."""
        d_loss = abs(float(met2["loss"]) - float(met1["loss"]))
        d_norm = abs(float(met2["grad_norm"]) - float(met1["grad_norm"])) / float(met1["grad_norm"])
        assert d_loss <= TOL_PT_LOSS and d_norm <= TOL_PT_NORM and d_param <= TOL_PT_PARAM, (
            f"{tag}: loss {d_loss:.3g}, grad_norm {d_norm:.3g} relative, params {d_param:.3g}")
        # the step must move the parameters far past the tolerance, or the check could not see a gradient
        assert moved >= 5 * TOL_PT_PARAM, f"{tag}: the one-device step moved the parameters by {moved:.3g}"
        res.setdefault("equality", {})[tag] = dict(loss_diff=d_loss, grad_norm_rel_diff=d_norm, param_diff=d_param,
                                                   largest_update=moved)

    # (1) equality: f32, TF32 off, ViT-L/14 widths at TRAIN_SMALL_LAYERS a tower
    t0 = time.perf_counter()
    small = dataclasses.replace(CM.ARCHS["ViT-L/14"], vision_layers=TRAIN_SMALL_LAYERS, text_layers=TRAIN_SMALL_LAYERS)
    base = CM.build_model("ViT-L/14", dtype=torch.float32, seed=0, device=dev, arch=small)
    pipe16, host = host_batch(PT_BATCH)
    cfg = TrainConfig(batch_size=PT_BATCH, global_negatives=True, lr=PT_LR)
    p0 = {n: p.detach().clone() for n, p in base.named_parameters()}  # the start: each step's largest update
    for tag, layout in PT_LAYOUTS.items():
        compare(tag, base, cfg, host, layout)
    # DP4 with local negatives: the mean of the four shard losses, each on its own rows
    m = copy.deepcopy(base)
    local = dataclasses.replace(cfg, global_negatives=False)
    state, step = make(m, local, PT_LAYOUTS["dp4"])
    with torch.no_grad():
        per = []
        for j in range(PT_SHARDS):
            rows = {k: v[j * 4:(j + 1) * 4] for k, v in on_dev(host).items()}
            img, q, t = TT.encode_batch(m, None, rows["images"], rows["query_ids"], rows["target_ids"])
            per.append(float(joint_contrastive_loss(img, q, t, temperature=local.temperature,
                                                    t2i_weight=local.t2i_weight, t2t_weight=local.t2t_weight)[0]))
    _, met = step(state, dict(host))
    d = abs(float(met["loss"]) - float(np.mean(per)))
    assert d <= TOL_PT_LOSS, f"dp4 local negatives: {float(met['loss'])} against the shards' mean {np.mean(per)}"
    res["equality"]["dp4 local negatives (the shards' mean)"] = dict(loss_diff=d)
    # the variants under DP4
    ad = lora_init(dict(base.named_parameters()), 8, "all", torch.Generator().manual_seed(0))
    compare("lora dp4", base, dataclasses.replace(cfg, lora_rank=8, lora_alpha=16.0), host, PT_LAYOUTS["dp4"],
            adapters=ad)
    compare("gradcache dp4", base, dataclasses.replace(cfg, grad_cache_chunks=2), host, PT_LAYOUTS["dp4"])
    table = np.stack([np.roll(np.arange(PT_BATCH), -(i + 1))[:4] for i in range(PT_BATCH)]).astype(np.int32)
    neg_host = dict(host, neg_ids=pipe16.negative_target_ids(np.arange(PT_BATCH), table, 2))
    compare("mined negatives dp4", base, dataclasses.replace(cfg, hard_negatives="table", hard_negatives_k=2),
            neg_host, PT_LAYOUTS["dp4"])
    # distillation: each shard's KD on its own in-batch matrices; the one-device reference averages them by hand
    rng = np.random.default_rng(3)
    teach = {k: (lambda x: x / np.linalg.norm(x, axis=1, keepdims=True))(
        rng.standard_normal((PT_BATCH, small.embed_dim)).astype(np.float32)) for k in ("t_img", "t_q", "t_t")}
    dcfg = dataclasses.replace(cfg, distill_teacher="teacher")
    m1, m2 = copy.deepcopy(base), copy.deepcopy(base)
    s1 = TT.TrainState(m1, TT.make_optimizer(dcfg, 1, m1))
    params1 = dict(m1.named_parameters())
    dev_h = on_dev(dict(host, **teach))
    losses = []
    for j in range(PT_SHARDS):
        sl = slice(j * 4, (j + 1) * 4)
        img, q, t = TT.encode_batch(m1, None, dev_h["images"][sl], dev_h["query_ids"][sl], dev_h["target_ids"][sl])
        losses.append(TD.distill_loss(img, q, t, dev_h["t_img"][sl], dev_h["t_q"][sl], dev_h["t_t"][sl],
                                      temperature=dcfg.temperature, t2i_weight=dcfg.t2i_weight,
                                      t2t_weight=dcfg.t2t_weight, kd_weight=dcfg.distill_kd_weight,
                                      embed_weight=dcfg.distill_embed_weight)[0])
    loss1 = torch.stack(losses).mean()
    loss1.backward()
    _, met1 = TT.apply_gradients(s1, TT.collect_grads(params1), {"loss": loss1.detach()})
    s2, f2 = make(m2, dcfg, PT_LAYOUTS["dp4"], distill=True)
    s2, met2 = f2(s2, dict(host, **teach))
    record("distill dp4 (the shards' KD averaged by hand)", met1, met2,
           max(float((p.detach() - params1[n].detach()).abs().max()) for n, p in m2.named_parameters()),
           max(float((p.detach() - p0[n]).abs().max()) for n, p in params1.items()))
    del base
    wall["equality"] = time.perf_counter() - t0
    log("parallel training equality (f32, ViT-L/14 widths, {} layer a tower, batch {}, lr {}): ".format(
        TRAIN_SMALL_LAYERS, PT_BATCH, PT_LR) + "; ".join(f"{k} loss {v['loss_diff']:.2e}" + (
            f", grad_norm {v['grad_norm_rel_diff']:.2e} relative, params {v['param_diff']:.2e} of an update of"
            f" {v['largest_update']:.2e}" if "param_diff" in v else "") for k, v in res["equality"].items()))

    # (2) full depth: ViT-L/14, bf16 compute, batch 64 (the serving phases' seeded model, copied for each step);
    # each peak counts that model too, the same bytes in every layout
    t0 = time.perf_counter()
    full = model
    replicated = sum(p.numel() * p.element_size() * 3 for p in full.parameters())  # parameter + AdamW's two moments
    pipe64, host64 = host_batch(PT_FULL_BATCH)
    cfg64 = TrainConfig(batch_size=PT_FULL_BATCH, global_negatives=True)
    res["full_depth"] = {}
    for tag in ("dp4", "fsdp4", "dp2xtp2"):
        m = copy.deepcopy(full)
        state, step = make(m, cfg64, PT_LAYOUTS[tag])
        batch = TT.as_row_shards(host64, rt_of(PT_LAYOUTS[tag]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        dispatch.reset_launch_counts()
        for _ in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, met = step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(float(met["loss"]))
        b6[f"{tag} ViT-L/14"] = dispatch.launch_counts()[flash]
        assert all(np.isfinite(losses)), f"{tag}: losses {losses}"
        out = dict(step_ms=float(np.median(times[1:])), max_memory_allocated=torch.cuda.max_memory_allocated(),
                   losses=losses)
        if state.layout is not None and tag.startswith("fsdp"):
            per = state.layout.position_bytes(state.optimizer.moment_tensors())
            worst = max(abs(x - replicated / PT_SHARDS) for x in per) / (replicated / PT_SHARDS)
            assert worst <= TOL_PT_FSDP_STATE, f"fsdp4 state a position {per} against {replicated / PT_SHARDS:.0f}"
            unit = max(p.numel() * p.element_size() for p in full.visual.transformer.resblocks[0].parameters())
            unit = max([unit] + [p.numel() * p.element_size() for n, p in full.named_parameters() if ".resblocks." not in n])
            built = state.layout.gauge.peak
            assert 0 < built <= unit, f"fsdp4 held {built} built bytes at once, its largest unit {unit}"
            out.update(state_bytes_per_position=per, replicated_state_bytes=replicated, worst_share_error=worst,
                       built_peak_bytes=built, largest_unit_bytes=unit)
        res["full_depth"][tag] = out
        del m, state, step, batch
        torch.cuda.empty_cache()
    wall["full depth"] = time.perf_counter() - t0
    fd = res["full_depth"]
    log("parallel training at ViT-L/14, bf16, batch {} ({}): ".format(PT_FULL_BATCH, "[cuda:0] x 4") + "; ".join(
        f"{k} {v['step_ms']:.1f} ms a step (the whole-model build's run: {PT_EARLIER_MS[k]} ms), peak "
        f"{v['max_memory_allocated'] / 2**30:.2f} GiB" for k, v in fd.items()) + "; fsdp4 state a position {} of {} "
        "bytes replicated".format(fd["fsdp4"]["state_bytes_per_position"], replicated))
    log(f"parallel training peaks side by side: fsdp4 {fd['fsdp4']['max_memory_allocated'] / 2**30:.2f} GiB, dp4 "
        f"{fd['dp4']['max_memory_allocated'] / 2**30:.2f} GiB; fsdp4 built at most "
        f"{fd['fsdp4']['built_peak_bytes'] / 2**20:.1f} MiB at once (its largest unit "
        f"{fd['fsdp4']['largest_unit_bytes'] / 2**20:.1f} MiB)")
    assert fd["fsdp4"]["max_memory_allocated"] < fd["dp4"]["max_memory_allocated"], (
        f"fsdp4 peak {fd['fsdp4']['max_memory_allocated']} not below dp4's {fd['dp4']['max_memory_allocated']}")

    # (3) two cli.train processes over gloo on the card, against one process over [cuda:0] * 2
    t0 = time.perf_counter()
    import torch.distributed as dist

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.common import build_model, build_pipeline
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

    root = tempfile.mkdtemp(dir=tmp)
    seed_pt = os.path.join(root, "small.pt")
    seed_model = CM.build_model("ViT-L/14", dtype=torch.float32, seed=1, arch=small)
    start_mp = {n: p.detach().clone() for n, p in seed_model.named_parameters()}
    save_openai_pt(seed_model, seed_pt)
    del seed_model
    common = ["--model.name=ViT-L/14", f"--model.checkpoint={seed_pt}", "--model.dtype=float32",
              f"--data.dataset=synthetic:{PT_MP_N}", f"--train.batch_size={PT_MP_BATCH}", "--train.epochs=2",
              "--train.global_negatives=true", "--train.early_stop_patience=1", "--data.num_workers=2",
              f"--train.lr={PT_MP_LR}"]
    port, procs, logs = free_port(), [], []
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
            log_f = open(os.path.join(root, f"mp{rank}.log"), "w+")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MP_TRAIN, os.path.join(root, f"rank{rank}.pt"), f"--device={dev.type}",
                 *common, f"--train.checkpoint_dir={root}/ckpt", f"--eval.output_dir={root}/out{rank}"],
                cwd=REPO, env=env, stdout=log_f, stderr=subprocess.STDOUT, text=True))
        # the one-process reference while the two run: the same global batches over [cuda:0] * 2
        one_cfg = config_from_argv(common + [f"--train.checkpoint_dir={root}/one", f"--eval.output_dir={root}/one"])
        one_model = build_model(one_cfg, dev)
        pipe = build_pipeline(one_cfg, one_cfg.data.split_train)
        one = TT.CLIPTrainer(one_model, pipe, pipe, one_cfg.train, out_dir=f"{root}/one", rt=rt_of(
            dict(data_parallel=2), 2))
        one_result = one.train()
        one_params = one.params()
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"cli.train rank exited {p.returncode}:\n{out[-3000:]}"
    assert "runtime_init: torch.distributed gloo" in outs[0], "gloo did not run"
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    r0, r1 = (r["result"] for r in ranks)
    mon = [[h["monitor"] for h in r["history"]] for r in (r0, r1)]
    assert mon[0] == mon[1] and [h["steps"] for h in r0["history"]] == [h["steps"] for h in r1["history"]]
    assert (r0["epochs_run"], r0["best_epoch"]) == (r1["epochs_run"], r1["best_epoch"])
    assert all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in ranks[0]["params"])
    d_mp = max(float((ranks[0]["params"][n].detach().to(dev) - v.detach()).abs().max())
               for n, v in one_params.items())
    mp_moved = max(float((v.detach() - start_mp[n].to(dev)).abs().max()) for n, v in one_params.items())
    assert d_mp <= TOL_PT_MP and mp_moved >= 5 * TOL_PT_MP, f"two processes against one: {d_mp} of {mp_moved}"
    one_mon = [h["monitor"] for h in one_result["history"]]
    assert len(one_mon) == len(mon[0]) and max(abs(a - b) for a, b in zip(one_mon, mon[0])) <= TOL_PT_MP, (
        f"monitors: one process {one_mon}, the ranks {mon[0]}")
    assert os.path.exists(f"{root}/out0/train_metrics.jsonl") and not os.path.exists(f"{root}/out1/train_metrics.jsonl")
    res["two_process"] = dict(wall_s=time.perf_counter() - t0, monitors=mon[0], one_process_monitors=one_mon,
                              steps=[h["steps"] for h in r0["history"]], param_diff=d_mp, largest_update=mp_moved)
    # (4) pp / sp / ep across the two ranks (pp_sp_ep_across_processes, run in each after cli.train)
    res["pp_sp_ep"] = ppx = [json.load(open(os.path.join(root, f"rank{r}.pt.pp_sp_ep.json"))) for r in range(2)]
    assert sorted(ppx[0]["checks"]["pp across processes"]["positions"]
                  + ppx[1]["checks"]["pp across processes"]["positions"]) == list(range(PPX_STAGES))
    for r, rep in enumerate(ppx):
        n_blocks = CM.ARCHS["ViT-L/14"].text_layers
        pp_b6[f"rank {r}: its {n_blocks // 2} text blocks x {PPX_MICRO} microbatches, forward + recompute (s=77)"] = (
            rep["launches"]["pp across processes"])
        pp_b6[f"dp2 x pp2, rank {r}: its row's {n_blocks} blocks x {PPX_MICRO} microbatches, forward + recompute "
              "(s=77)"] = rep["launches"]["dp2 x pp2"]
        for name, c in rep["checks"].items():
            hops = ", ".join(f"{k} {v['messages']} messages {v['bytes'] / 2**20:.1f} MiB {v['seconds']:.3f} s"
                             for k, v in c["hops"].items()) or "no hop"
            log(f"pp / sp / ep across processes, rank {r}, {name}: {c['wall_s']:.2f} s ({hops}); " + ", ".join(
                f"{k} {v:.2e}" for k, v in c.items() if isinstance(v, float) and k != "wall_s"))
    for key in ("sp dense reference float32", "sp dense reference bfloat16", "sp block reference"):
        b6[key] = ppx[0]["launches"][key]
    wall["pp / sp / ep in the ranks"] = max(sum(c["wall_s"] for c in rep["checks"].values()) for rep in ppx)
    shutil.rmtree(root)
    # one data-parallel step and a validation encode under a world-size-1 NCCL group
    t1 = time.perf_counter()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        m = copy.deepcopy(full)
        rt = rt_of(PT_LAYOUTS["dp4"])
        assert rt.mesh.group is not None
        state, step = make(m, cfg64, PT_LAYOUTS["dp4"])
        dispatch.reset_launch_counts()
        state, met = step(state, dict(host64))
        enc = TT.make_encode_step(m, rt)(None, host64["images"][:8], host64["query_ids"][:8], host64["target_ids"][:8])
        torch.cuda.synchronize()
        b6["dp4 NCCL world 1 (step + encode)"] = dispatch.launch_counts()[flash]
        assert np.isfinite(float(met["loss"])) and all(e.shape == (8, full.arch.embed_dim) for e in enc)
        del m, state, step
    finally:
        dist.destroy_process_group()
    res["two_process"]["nccl_world1_s"] = time.perf_counter() - t1
    wall["two processes + NCCL"] = time.perf_counter() - t0
    log(f"parallel training: two cli.train processes over gloo {res['two_process']['wall_s']:.1f} s (monitors "
        f"{mon[0]}, one process {res['two_process']['one_process_monitors']}, params against one process "
        f"{d_mp:.2e}); NCCL world 1 step + encode {res['two_process']['nccl_world1_s']:.1f} s")

    # (5) the sharded int8 validation encode over 4 shards against one device
    t0 = time.perf_counter()
    with _Tally([(FE, "encode_image_fast"), (FE, "encode_text_fast")]) as tally:
        sharded = encode_dataset(full, pipe64, batch_size=PT_FULL_BATCH, quantize="int8", rt=rt_of(PT_LAYOUTS["dp4"]))
    one = encode_dataset(full, pipe64, batch_size=PT_FULL_BATCH, quantize="int8")
    res["int8_encode"] = {}
    for key in ("image", "query", "target"):
        a, b = getattr(sharded, key), getattr(one, key)
        cos = float(np.min(np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))))
        within = float(np.mean(np.abs(a - b) <= 1e-3))
        assert cos > STORE_COS and within >= 0.995, f"sharded int8 encode {key}: cosine {cos}, within 1e-3 {within}"
        res["int8_encode"][key] = dict(min_cosine=cos, share_within_1e3=within, max_abs_err=float(np.abs(a - b).max()))
    wall["int8 encode"] = time.perf_counter() - t0
    del full
    torch.cuda.empty_cache()
    log("parallel training sharded int8 encode (4 shards, 64 rows): " + "; ".join(
        f"{k} min cosine {v['min_cosine']:.7f}, max |diff| {v['max_abs_err']:.2e}" for k, v in res["int8_encode"].items()))

    vis = f" vision [{V_BATCH}x{V_SEQ}]"
    paths = {
        "B6 flash_attention s=257": dict({f"parallel training: {k} (both towers, every shard)": n for k, n in b6.items()
                                          if not k.startswith("sp ")},
                                         **{f"pp across processes: {k}": n for k, n in pp_b6.items()}),
        "B7 flash_attention s=577": {f"parallel training: {k} (s=1024)": n for k, n in b6.items() if k.startswith("sp ")},
        "B1 fused_layer_q8": {"parallel training: sharded int8 encode, text towers (4 shards)":
                              tally.of("encode_text_fast", "fused_layer_q8")},
        f"B1 fused_layer_q8{vis}": {"parallel training: sharded int8 encode, image tower (4 shards)":
                                    tally.of("encode_image_fast", "fused_layer_q8")},
    }
    for line_name, by in paths.items():
        for path, n in by.items():
            assert n > 0, f"{line_name} never launched on {path}"
    res["launches_by_path"] = paths
    res["phase_s"] = time.perf_counter() - t_phase
    res["wall_s"] = wall
    log(f"parallel training phase: {res['phase_s']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in wall.items())})")
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import build_model
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 matmuls in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = dispatch.build_library(verbose=True)
    dispatch.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    results = {}
    kernel_phases(torch, dev, results)
    vision_kernel_phases(torch, dev, results)
    capacity_kernel_phases(torch, dev, results)
    block_q8_phases(torch, dev, results)
    interior_phase(torch, dev, results)
    topk_over_kernel_k_phase(torch, dev)
    gemm_edge_phase(torch, dev)
    attention_routing_phase(torch, dev, results)
    prof_ms, prof = profiler_phase(torch)
    route = routing_phase(torch, dev, results)

    rng = np.random.default_rng(2)
    norm = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    model = build_model("ViT-L/14", dtype=torch.bfloat16, seed=0, device=dev)  # the weights precompute.main draws
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store.npz")
        EmbeddingStore(
            image=norm(rng.standard_normal((CORPUS, WIDTH))),
            text=norm(rng.standard_normal((CORPUS, WIDTH))),
            uuids=[f"uuid-{i:06d}" for i in range(CORPUS)],
        ).save(store_path)
        fast = serve_phase(torch, dev, model, store_path, "fast", results)
        int8 = serve_phase(torch, dev, model, store_path, "int8", results)
        t0 = time.perf_counter()
        cap = capacity_phases(torch, dev, model, tmp, results)
        log(f"capacity serve phases: {time.perf_counter() - t0:.1f} s")
        sh = sharded_serving_phase(torch, dev, tmp, model, store_path, os.path.join(tmp, "clustered.npz"), results)
        daemon = daemon_phase(torch, dev, tmp, store_path, results)
        ev = eval_phase(torch, dev, tmp, results)
        fu = fusion_phase(torch, dev, tmp, store_path, results)
        qu = quality_phase(torch, dev, tmp, results)
        ckpt_dir = tempfile.mkdtemp(dir=tmp)  # ~5 GB of ViT-L/14 checkpoints, gone with tmp
        ck, pt_path = checkpoint_layouts_phase(torch, dev, ckpt_dir, store_path, model, results)
        pa = parity_phase(torch, dev, ckpt_dir, pt_path, model, results)
        shutil.rmtree(ckpt_dir)
        baseline_phase(torch, dev, results)
        sc = profiling_scripts_phase(torch, dev, results)
        tr = train_phase(torch, dev, tmp, store_path, results, model)
        tv = train_variants_phase(torch, dev, tmp, store_path, results)
        pt = parallel_training_phase(torch, dev, tmp, model, results)

        stores, pre, pre336 = {}, {}, {}
        for enc in ("flax", "fast", "int8"):
            stores[enc], pre[enc], _ = precompute_phase(torch, tmp, "ViT-L/14", N_DOCS, 224, enc)
        _agree(stores, "flax", "ViT-L/14")
        for enc in ("flax", "fast", "int8"):
            precompute_stages(torch, dev, model, enc, results)
        fast_vision_vs_cpu(torch, dev, model)
        iq = image_query_phase(torch, dev, model, store_path, stores["fast"], results)
        del model
        torch.cuda.empty_cache()
        stores336 = {}
        for enc in ("flax", "fast", "int8"):
            stores336[enc], pre336[enc], _ = precompute_phase(torch, tmp, "ViT-L/14@336px", 32, 336, enc)
        _agree(stores336, "flax", "ViT-L/14@336px")

    for name in ("fused_attention_block", "fused_mlp_block", "similarity_topk_kernel"):
        assert iq[name] > 0, f"{name} never launched while image queries were answered"
    vis, v336 = f" vision [{V_BATCH}x{V_SEQ}]", f" 336px [4x{V336_SEQ}]"
    launches = {
        "B3a fused_attention_block": fast["fused_attention_block"],
        "B3b fused_mlp_block": fast["fused_mlp_block"],
        "B1 fused_layer_q8": int8["fused_layer_q8"],
        "B2 similarity_topk exact": fast["similarity_topk_kernel"],
        "B2 similarity_topk q8": int8["similarity_topk_kernel"],
        f"B3a fused_attention_block{vis}": pre["fast"]["fused_attention_block"],
        f"B3b fused_mlp_block{vis}": pre["fast"]["fused_mlp_block"],
        f"B1 fused_layer_q8{vis}": pre["int8"]["fused_layer_q8"],
        "B6 flash_attention s=257": pre["flax"]["flash_attention_kernel"],
        f"B3a fused_attention_block{v336}": pre336["fast"]["fused_attention_block"],
        f"B1 fused_layer_q8{v336}": pre336["int8"]["fused_layer_q8"],
        "B7 flash_attention s=577": pre336["flax"]["flash_attention_kernel"],
        "B2 similarity_topk exact, image queries": iq["similarity_topk_kernel"],
        f"B2-q4 similarity_topk q4 [{CORPUS}]": cap["int4"]["similarity_topk_kernel"],
        f"B2-q4 similarity_topk q4 [{SCALE_ROWS}]": cap["int4"]["similarity_topk_kernel"],
        f"B5 pq_adc_topk [{CORPUS}]": cap["pq"]["pq_adc_topk_kernel"] + cap["pq+opq"]["pq_adc_topk_kernel"],
        f"B5 pq_adc_topk [{SCALE_ROWS}]": cap["pq"]["pq_adc_topk_kernel"] + cap["pq+opq"]["pq_adc_topk_kernel"],
        f"B5 pq_adc_topk [{CORPUS}] k=128": cap["pq"]["pq_adc_topk_kernel"] + cap["pq+opq"]["pq_adc_topk_kernel"],
        f"B5 pq_adc_topk [{CORPUS}] k=400": cap["pq"]["pq_adc_topk_kernel"] + cap["pq+opq"]["pq_adc_topk_kernel"],
        "B2 similarity_topk q8 k=400": cap["rerank top_k=100"]["similarity_topk_kernel"],
        f"B2 similarity_topk q8 [{SCALE_ROWS}] {SHARDS} shards": sh["b2_q8_1m"]["similarity_topk_kernel"],
        # the profiler's run (its shape is the vision one) plus the over-the-cap route
        f"B4a fused_attention_block_q8{vis}": prof["fused_attention_block_q8"] + route["fused_attention_block_q8"],
        f"B4a fused_attention_block_q8{v336}": prof["fused_attention_block_q8"] + route["fused_attention_block_q8"],
        f"B4b fused_mlp_block_q8{vis}": prof["fused_mlp_block_q8"] + route["fused_mlp_block_q8"],
    }
    # the launches of this slice's paths, beside each kernel's earlier ones
    by_path = {
        "B6 flash_attention s=257": {"eval flax image tower": ev["flax"]["image"]["flash_attention_kernel"],
                                     "eval flax text tower (s=77)": ev["flax"]["text"]["flash_attention_kernel"]},
        "B3a fused_attention_block": {"eval fast text tower": ev["fast"]["text"]["fused_attention_block"]},
        "B3b fused_mlp_block": {"eval fast text tower": ev["fast"]["text"]["fused_mlp_block"]},
        f"B3a fused_attention_block{vis}": {"eval fast image tower": ev["fast"]["image"]["fused_attention_block"]},
        f"B3b fused_mlp_block{vis}": {"eval fast image tower": ev["fast"]["image"]["fused_mlp_block"]},
        "B1 fused_layer_q8": {"eval int8 text tower": ev["int8"]["text"]["fused_layer_q8"],
                              "fused daemon text encoder": fu["fused daemon"]["fused_layer_q8"],
                              "cli.train_fusion int8, both towers": fu["train_fusion"]["fused_layer_q8"]},
        f"B1 fused_layer_q8{vis}": {"eval int8 image tower": ev["int8"]["image"]["fused_layer_q8"]},
        "B2 similarity_topk q8": {"fused serving top_k=20 (fetch 80)": fu["fused top_k=20"]["similarity_topk_kernel"],
                                  "quality sweep int8 rows": qu["int8"], "autotune int8 rows": qu["autotune"]["int8"]},
        "B2 similarity_topk q8 k=400": {"fused daemon (fetch 400)": fu["fused daemon"]["similarity_topk_kernel"],
                                        "fused serving top_k=100 (fetch 400)":
                                            fu["fused top_k=100"]["similarity_topk_kernel"]},
        f"B2-q4 similarity_topk q4 [{CORPUS}]": {"quality sweep int4 rows": qu["int4"],
                                                 "autotune int4 rows": qu["autotune"]["int4"]},
        f"B5 pq_adc_topk [{CORPUS}]": {"quality sweep pq rows": qu["pq"], "autotune pq rows": qu["autotune"]["pq"]},
    }
    # this slice's paths (checkpoint layouts, the parity runbook, the profiling scripts)
    ps, pv, vs, pq, ivf, sb = (sc[n] for n in ("profile_serving", "profile_vision", "vision_batch_sweep",
                                                "profile_pq", "profile_ivf", "scale_bench"))
    sim = "similarity_topk_kernel"
    slice_paths = {
        "B3a fused_attention_block": {
            "checkpoint layouts fast batch (3 models)": ck["fast"]["fused_attention_block"],
            "parity fast eval text tower": pa["fast"]["text"]["fused_attention_block"],
            "profile_serving": ps["total"]["fused_attention_block"]},
        "B3b fused_mlp_block": {
            "checkpoint layouts fast batch (3 models)": ck["fast"]["fused_mlp_block"],
            "parity fast eval text tower": pa["fast"]["text"]["fused_mlp_block"],
            "profile_serving": ps["total"]["fused_mlp_block"]},
        "B1 fused_layer_q8": {
            "checkpoint layouts int8 batch (3 models)": ck["int8"]["fused_layer_q8"],
            "parity int8 eval text tower": pa["int8"]["text"]["fused_layer_q8"],
            "profile_serving": ps["total"]["fused_layer_q8"]},
        "B2 similarity_topk exact": {
            "checkpoint layouts fast batch (3 models)": ck["fast"][sim],
            "profile_serving": ps["fused_similarity_topk"][sim], "profile_pq": pq["fused_similarity_topk"][sim]},
        "B2 similarity_topk q8": {
            "checkpoint layouts int8 batch (3 models)": ck["int8"][sim],
            "profile_serving": ps["fused_similarity_topk_q8"][sim], "profile_pq": pq["fused_similarity_topk_q8"][sim],
            f"profile_ivf brute scan ({IVF_ROWS:,} rows)": ivf["fused_similarity_topk_q8"][sim],
            f"scale_bench int8 ({SCALE_BENCH_ROWS:,} rows)": sb["fused_similarity_topk_q8"][sim]},
        f"B3a fused_attention_block{vis}": {
            "parity fast eval image tower": pa["fast"]["image"]["fused_attention_block"],
            "profile_vision": pv["total"]["fused_attention_block"],
            "vision_batch_sweep --bf16": vs["total"]["fused_attention_block"]},
        f"B3b fused_mlp_block{vis}": {
            "parity fast eval image tower": pa["fast"]["image"]["fused_mlp_block"],
            "profile_vision": pv["total"]["fused_mlp_block"],
            "vision_batch_sweep --bf16": vs["total"]["fused_mlp_block"]},
        f"B1 fused_layer_q8{vis}": {
            "parity int8 eval image tower": pa["int8"]["image"]["fused_layer_q8"],
            "profile_vision": pv["total"]["fused_layer_q8"],
            "vision_batch_sweep": vs["total"]["fused_layer_q8"]},
        f"B4a fused_attention_block_q8{vis}": {"profile_vision": pv["total"]["fused_attention_block_q8"]},
        f"B4b fused_mlp_block_q8{vis}": {"profile_vision": pv["total"]["fused_mlp_block_q8"]},
        "B6 flash_attention s=257": {
            "parity runs' image tower (flax eval + the converter forward)":
                sum(pa[e]["image"]["flash_attention_kernel"] for e in pa)},
        f"B2-q4 similarity_topk q4 [{CORPUS}]": {"profile_pq": pq["fused_similarity_topk_q4"][sim]},
        f"B2-q4 similarity_topk q4 [{SCALE_ROWS}]": {
            f"scale_bench int4 ({SCALE_BENCH_ROWS:,} rows)": sb["fused_similarity_topk_q4"][sim]},
        f"B5 pq_adc_topk [{CORPUS}]": {"profile_pq": pq["fused_pq_topk"]["pq_adc_topk_kernel"]},
        f"B5 pq_adc_topk [{SCALE_ROWS}]": {
            f"scale_bench pq ({SCALE_BENCH_ROWS:,} rows)": sb["pq_similarity_topk"]["pq_adc_topk_kernel"]},
    }
    for name, paths in slice_paths.items():
        by_path.setdefault(name, {}).update(paths)
    # this PR's path: sharded serving (item 24), each kernel once a shard or a query slice
    q8, b1, b3a, b3b = "B2 similarity_topk q8", "B1 fused_layer_q8", "B3a fused_attention_block", "B3b fused_mlp_block"
    sharded_paths = {
        "B2 similarity_topk exact": {"shard_corpus exact, 4 shards (256-query batch)": sh["shard_corpus exact"][sim],
                                     "shard_queries fast, 4 slices": sh["shard_queries fast"][sim]},
        q8: {"shard_corpus int8, 4 shards (256-query batch)": sh["shard_corpus int8"][sim],
             "shard_queries int8, 4 slices": sh["shard_queries int8"][sim],
             "multi-host NCCL world 1, 2 shards x 2 work items": sh["multihost nccl"][sim]},
        f"B2-q4 similarity_topk q4 [{CORPUS}]": {"shard_corpus int4, 4 shards": sh["shard_corpus int4"][sim]},
        f"B5 pq_adc_topk [{CORPUS}]": {"sharded pq, 4 shards": sh["sharded pq"]["pq_adc_topk_kernel"]},
        b1: {"shard_queries int8, 4 slices": sh["shard_queries int8"]["fused_layer_q8"],
             "shard_corpus int8 encoder": sh["shard_corpus int8"]["fused_layer_q8"]},
        b3a: {"shard_queries fast, 4 slices": sh["shard_queries fast"]["fused_attention_block"]},
        b3b: {"shard_queries fast, 4 slices": sh["shard_queries fast"]["fused_mlp_block"]},
    }
    for name, paths in sharded_paths.items():
        by_path.setdefault(name, {}).update({f"sharded serving: {p}": n for p, n in paths.items()})
    # this slice's path: training (item 22)
    by_path["B6 flash_attention s=257"].update({f"train: {path}": n for path, n in tr.items()})
    # this slice's paths: the training variants (item 23), parallel training (item 25)
    for name, paths in (*tv.items(), *pt.items()):
        by_path.setdefault(name, {}).update(paths)
    for name in results:
        if name.startswith("S1 "):
            launches[name] = prof["attn_q8_variant"]
        elif name.startswith("S2 "):
            launches[name] = prof["mlp_q8_diag"]
    assert prof["fused_layer_q8"] > 0, "the profiler's whole-layer line never launched B1"
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched in the path it belongs to")
        results[name]["launches"] = n
    for name, paths in by_path.items():
        for path, n in paths.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on {path}")
        results[name]["launches_by_path"] = {"earlier slices' paths": results[name]["launches"], **paths}
        results[name]["launches"] += sum(paths.values())
    kernels = [results[name] for name in launches]
    log(f"serve batch medians: fast {results['serve_fast_batch_ms']:.2f} ms, int8 {results['serve_int8_batch_ms']:.2f} ms")
    log("capacity tiers (256-query batch ms, recall@10 text queries / corpus rows): " + "; ".join(
        f"{tier} {v['batch_ms']:.2f} ms, {v['recall_at_10']:.4f} / {v['recall_at_10_corpus_rows']:.4f}"
        for tier, v in results["capacity_tiers"].items()))
    log("vision-interior profiler medians (ms): " + "; ".join(f"{k} {v:.3f}" for k, v in prof_ms.items()))
    log("precompute images/s (build_embedding_store, synthetic:300, batch 256): " + ", ".join(
        f"{enc} {results[f'precompute_{enc}']['images_per_s']:.1f}" for enc in ("flax", "fast", "int8")))
    d = results["daemon"]
    log(f"daemon (ViT-L/14 int8, {DAEMON_CLIENTS} clients): {d['qps']:.1f} q/s; text p50/p95/p99 "
        f"{d['text_ms']['p50']:.2f} / {d['text_ms']['p95']:.2f} / {d['text_ms']['p99']:.2f} ms; launches int8 "
        f"B1 {daemon['int8']['fused_layer_q8']}, B2 q8 {daemon['int8']['similarity_topk_kernel']}; fast B3a "
        f"{daemon['fast']['fused_attention_block']}, B3b {daemon['fast']['fused_mlp_block']}, B2 exact "
        f"{daemon['fast']['similarity_topk_kernel']}")
    e, fu_r = results["eval"], results["fusion"]
    log(f"eval (ViT-L/14, synthetic:{EVAL_N}, cli.evaluate): " + "; ".join(
        f"{m} encode {v['encode_s']:.2f} s, metrics {v['metrics_s']:.3f} s, sweep {v['sweep_s']:.3f} s, "
        f"run {v['wall_s']:.2f} s" for m, v in e["split"].items())
        + f"; fusion sweep at {CORPUS} rows {e['sweep_cell_ms']:.1f} ms a cell; phase {e['phase_s']:.1f} s")
    log(f"fusion: cli.train_fusion {fu_r['train_cli_s']:.2f} s; heads {fu_r['head_train_s']}; fused daemon "
        f"{fu_r['fused']['qps']:.1f} requests/s, p50 {fu_r['fused']['p50_ms']:.2f} ms, p99 {fu_r['fused']['p99_ms']:.2f} "
        f"ms; phase {fu_r['phase_s']:.1f} s ({smi})")
    log(f"quality: sweep {results['quality']['sweep_s']:.1f} s, autotune {results['quality']['autotune_s']:.1f} s, "
        f"recall against the served tiers {results['quality']['recall_diff']}; phase {results['quality']['phase_s']:.1f} s")
    log("items 18-25 phases (s): " + ", ".join(f"{n} {results[n]['phase_s']:.1f}" for n in
                                         ("checkpoints", "parity", "baseline", "scripts", "train", "train_variants",
                                          "sharded_serving", "parallel_training"))
        + "; scripts " + ", ".join(f"{n} {t:.1f}" for n, t in results["scripts"]["wall_s"].items()))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
