"""Serving entry point: knowledge-enhanced retrieval queries and the HTTP daemon.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/serve.py``:
load a precomputed embedding store, build the CLIP towers (checkpoint or
seeded weights), wire the Text2SPARQL retriever when its endpoints are
configured, and answer one query, a batch from stdin, or HTTP requests:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.serve \
        --store=data/embeddings/store.npz --model.name=ViT-L/14 \
        --eval.encoder=int8 --eval.quantize_corpus=int8 \
        [--device=cuda] [--query="madonna and child" | --batch < queries.txt]

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.serve \
        --store=store.npz --eval.encoder=int8 --eval.quantize_corpus=int8 \
        --http 8080 [--http-host 0.0.0.0] [--max-pending 512] \
        [--cache-results 4096] [--warmup 1,2,4,8,16,32,64,128,256] [--bucket-queries]

The daemon (``retrieval.http_server``) serves ``/search`` (per-request
alpha, ``allow_uuids`` / ``deny_uuids`` filters, per-query ``candidates``),
``/search_image``, ``POST`` / ``DELETE /documents`` (embeddings or raw
images and texts, encoded on the device), ``/snapshot`` (the live corpus
back to ``--store``), ``/healthz`` and ``/metrics``; SIGTERM drains it.
``--warmup`` runs each listed batch size at every seq bucket (and the image
search) before the socket opens; ``--bucket-queries`` splits micro-batches
by seq bucket.

The capacity tiers take the JAX CLI's flags: ``--eval.quantize_corpus=
int4|pq|binary``, ``--eval.pq_m``, ``--eval.pq_aniso_t``, ``--eval.rotate``
with ``--eval.rotate_mode=random|opq`` and ``--eval.rotate_seed``,
``--eval.truncate_dim``, ``--eval.rerank`` with ``--eval.rerank_factor``,
and ``--eval.ann=ivf`` with ``--eval.ann_nlist``, ``--eval.ann_nprobe``,
``--eval.ann_index`` (an index cache, e.g. from ``cli.index``) and
``--eval.ann_max_batch_lookups``. ``--eval.mmap_store`` memory-maps the
store's rows. ``--fusion.head_params=<head.npz>`` (a ``cli.train_fusion``
artifact of either package) serves a trained fusion head: the one-shot and
``--batch`` answers and HTTP ``{"fused": true}`` rescore the blended
top-(``--fusion.factor`` x k) candidates with it.

Over a device mesh (``--mesh.data_parallel`` etc.; the cards by default, a
card repeating when the layout asks for a multiple of them, ``cpu`` with
``--device=cpu``): ``--eval.shard_corpus=true`` shards the corpus rows over
the mesh (capacity), ``--eval.shard_queries=true`` the query batches
(throughput). ``--multihost`` serves one sharded corpus from several
processes: every process runs the same command under ``torchrun`` (or with
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``;
``KEMR_NUM_PROCESSES`` may stand for ``WORLD_SIZE``); ``parallel.mesh.runtime_init`` starts
``torch.distributed`` (NCCL where each rank owns a card, gloo otherwise),
rank 0 answers queries or HTTP and the followers execute each broadcast work
item of ``--multihost-batch`` queries in lockstep (``retrieval.multihost``).
``/healthz`` answers 503 once a work item stalls.

``--device`` defaults to ``cuda`` and never falls back: serving on the CPU
(the kernels' plain versions) takes ``--device=cpu``.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..utils.config import (
    Endpoints,
    config_from_argv,
    resolve_encoder,
    resolve_quantize_corpus,
)

from ..data.tokenizer import CLIPTokenizer
from ..retrieval.clip_retrieval import CLIPRetrieval
from ..retrieval.embedding_store import EmbeddingStore
from ..retrieval.engine import RetrievalEngine
from ..retrieval.http_server import RetrievalHTTPServer
from .common import build_model, build_runtime, pop_flag, resolve_device

logger = logging.getLogger("kemr_torch.cli.serve")  # standard error: standard output carries the answers


def build_engine(cfg, store_path: str, device, kg_path: str = "") -> RetrievalEngine:
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    model = build_model(cfg, device)
    tokenizer = CLIPTokenizer.find_default()
    store = EmbeddingStore.load(store_path, mmap=cfg.eval.mmap_store)
    # eval.encoder: flax (module tower), fast (bf16 fused layers), int8 (W8A8)
    use_fast, quantize = resolve_encoder(cfg.eval.encoder)
    rt = None
    if cfg.eval.shard_corpus or cfg.eval.shard_queries:
        rt = build_runtime(cfg, device)
        if rt.mesh.first_device != torch.device(device):
            device = rt.mesh.first_device  # the towers live where the merged results land
            model = model.to(device)
    clip_r = CLIPRetrieval(
        model, tokenizer, store,
        device=device,
        use_fused_encoder=use_fast,
        quantize=quantize,
        quantize_corpus=resolve_quantize_corpus(cfg.eval.quantize_corpus),
        capacity_multiple=cfg.eval.capacity_multiple,
        rt=rt,
        shard_corpus=cfg.eval.shard_corpus,
        shard_queries=cfg.eval.shard_queries,
        ann=cfg.eval.ann or None,
        ann_nlist=cfg.eval.ann_nlist or None,
        ann_nprobe=cfg.eval.ann_nprobe,
        ann_index_path=cfg.eval.ann_index or None,
        ann_max_batch_lookups=cfg.eval.ann_max_batch_lookups,
        rerank=cfg.eval.rerank,
        rerank_factor=cfg.eval.rerank_factor,
        truncate_dim=cfg.eval.truncate_dim,
        rotate=(cfg.eval.rotate_mode if cfg.eval.rotate else False),
        rotate_seed=cfg.eval.rotate_seed,
        pq_m=cfg.eval.pq_m,
        pq_aniso_t=cfg.eval.pq_aniso_t,
    )
    t2s = None
    env = Endpoints.from_env()
    has_kg = bool(kg_path) or bool(env.sparql_endpoint)
    if has_kg and env.mistral_api_key and env.mistral_agent_id:
        from ..knowledge.circuit import (
            CachedRetrieval,
            CircuitBreakerRetrieval,
        )
        from ..knowledge.clients import (
            HTTPSparqlClient,
            MistralAgentClient,
        )
        from ..knowledge.text2sparql import Text2SparqlRetrieval

        if kg_path:
            from ..knowledge.kg import LocalKGSparqlClient

            sparql_client = LocalKGSparqlClient(kg_path)
        else:
            sparql_client = HTTPSparqlClient()
        t2s = CachedRetrieval(
            CircuitBreakerRetrieval(
                Text2SparqlRetrieval(MistralAgentClient(), sparql_client, raise_errors=True),
                raise_on_degrade=True,
            )
        )
    engine = RetrievalEngine(clip_r, t2s, cfg.fusion)
    if cfg.fusion.head_params:
        # learned-fusion serving: a trained head artifact (either package's
        # cli.train_fusion) rescores stage-1 candidates where fused retrieval
        # is asked for (the CLI answers, HTTP {"fused": true}); plain /search
        # keeps the linear blend
        from ..train.fusion_trainer import load_fusion_head

        fm, fparams = load_fusion_head(cfg.fusion.head_params, device=device)
        engine.set_fusion_head(fm, fparams, factor=cfg.fusion.factor)
    return engine


@dataclass
class DaemonOptions:
    """The daemon's flags (``--http`` and its companions)."""

    port: Optional[int] = None  # None: no daemon
    host: str = "127.0.0.1"  # bind address (containers usually need 0.0.0.0)
    max_pending: int = 0  # 0 = queue without bound; > 0 = HTTP 503 past that many pending requests
    cache_results: int = 0  # (query, alpha) result-cache entries; emptied on every corpus update
    warmup: str = ""  # comma-separated batch sizes to run before serving
    bucket_queries: bool = False  # split micro-batches by seq bucket


def pop_daemon_flags(args) -> DaemonOptions:
    """Remove the daemon's flags from ``args``."""
    port = pop_flag(args, "--http")
    opts = DaemonOptions(
        port=None if port is None else int(port),
        host=pop_flag(args, "--http-host", "127.0.0.1"),
        max_pending=int(pop_flag(args, "--max-pending", "0")),
        cache_results=int(pop_flag(args, "--cache-results", "0")),
        warmup=pop_flag(args, "--warmup", ""),
        bucket_queries="--bucket-queries" in args,
    )
    if opts.bucket_queries:
        args.remove("--bucket-queries")
    return opts


def warm_engine(engine: RetrievalEngine, cfg, sizes: str, image: bool):
    """``--warmup``: run each batch size of ``sizes`` at every seq bucket
    (and the image search when the daemon serves it); returns (searches run,
    seconds)."""
    batch_sizes = [int(x) for x in sizes.split(",") if x.strip()]
    t0 = time.monotonic()
    n = engine.clip_retriever.warmup(batch_sizes, alpha=cfg.fusion.alpha_clip, image=image)
    return n, time.monotonic() - t0


def make_http_server(engine: RetrievalEngine, cfg, store_path: str, opts: DaemonOptions,
                     mh=None) -> RetrievalHTTPServer:
    """The daemon over ``engine``: the JAX CLI's wiring, hook for hook. The
    socket is bound here; serve with ``serve_forever()`` or ``start()``.
    Under multi-host serving (``mh``, the coordinator's
    ``MultiHostSearch``) filtered search and corpus updates answer 501 and
    ``/healthz`` reports the lockstep's stall state."""
    clip_r = engine.clip_retriever
    batch_fn = engine.retrieve_text_batch if engine.t2s_retriever else engine.retrieve_text_noknowledge_batch
    default_alpha = cfg.fusion.alpha_clip

    def resolve_alphas(alphas):
        # per-request blend (alpha in the request): None takes the default;
        # mixed alphas ride one micro-batch
        return [default_alpha if a is None else float(a) for a in alphas]

    def alphas_batch_fn(queries, alphas):
        return batch_fn(queries, alpha_clip=resolve_alphas(alphas))

    filtered_batch_fn = None
    if mh is None:
        def filtered_batch_fn(queries, alphas, allow, deny):
            # hard filters need an exact scan: under ann='ivf' this raises
            # ValueError, which the daemon answers with 400
            return engine.retrieve_text_filtered_batch(queries, allow, deny, alpha_clip=resolve_alphas(alphas))

    def candidates_batch_fn(queries, candidates, alphas):
        # caller-supplied candidate sets, scored exactly on the host store
        return clip_r.retrieval_candidates_batch(queries, candidates, alpha=resolve_alphas(alphas))

    fused_batch_fn = None
    if engine.fusion_head is not None:
        def fused_batch_fn(queries, alphas):
            return engine.retrieve_text_fused_batch(queries, alpha_clip=resolve_alphas(alphas))

    return RetrievalHTTPServer(
        batch_fn, host=opts.host, port=opts.port, max_pending=opts.max_pending,
        result_cache_size=opts.cache_results,
        alphas_batch_fn=alphas_batch_fn,
        # live corpus updates: searches serve the old corpus until the new
        # one swaps in; raw documents are encoded on the device. Multi-host
        # followers would not restage their shards: None answers 501
        add_documents_fn=None if mh is not None else clip_r.add_documents,
        remove_documents_fn=None if mh is not None else clip_r.remove_documents,
        encode_documents_fn=None if mh is not None else clip_r.encode_documents,
        # POST /snapshot writes the live corpus back to the store file
        # (atomic replace), so ingested documents survive a restart
        snapshot_fn=None if mh is not None else (
            lambda: {"path": store_path, "rows": clip_r.save_store(store_path)}),
        image_batch_fn=engine.retrieve_image_batch,
        image_preprocess_fn=clip_r.preprocess_images,
        filtered_batch_fn=filtered_batch_fn,
        candidates_batch_fn=candidates_batch_fn,
        # learned-fusion rescoring ({"fused": true}) only with a trained head
        # (--fusion.head_params); without one the daemon answers 501
        fused_batch_fn=fused_batch_fn,
        length_bucket_fn=clip_r.seq_bucket if opts.bucket_queries else None,
        # a dead follower blocks the coordinator inside a collective: past
        # the stall timeout /healthz answers 503 and the orchestrator restarts
        health_fn=mh.health if mh is not None else None,
    )


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    batch_mode = "--batch" in args
    if batch_mode:
        args.remove("--batch")
    store_path = pop_flag(args, "--store", "data/embeddings/store.npz")
    kg_path = pop_flag(args, "--kg", "")
    query = pop_flag(args, "--query")
    opts = pop_daemon_flags(args)
    # multi-host lockstep serving: every process of a torch.distributed job
    # runs this same command; the corpus shards over all their devices
    # (with --eval.shard_corpus=true), the followers join the broadcast
    # loop, the coordinator serves queries or HTTP as usual
    multihost = "--multihost" in args
    if multihost:
        args.remove("--multihost")
    mh_batch = int(pop_flag(args, "--multihost-batch", "32"))
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    logging.basicConfig(level=logging.INFO)
    if multihost and opts.warmup:
        # warmup searches directly: the followers are not in the broadcast loop yet
        raise ValueError("--warmup does not compose with --multihost")
    if multihost and cfg.fusion.head_params:
        raise ValueError(
            "--fusion.head_params does not compose with --multihost "
            "(fused rescoring uses candidate routes outside the broadcast)"
        )
    if multihost:
        from ..parallel.mesh import runtime_init

        backend = runtime_init()  # a no-op for one process
        logger.info("multihost: torch.distributed backend %s", backend or "none (one process)")
    engine = build_engine(cfg, store_path, device, kg_path=kg_path)
    mode = "knowledge-enhanced" if engine.t2s_retriever else "CLIP-only (no KG endpoints configured)"
    logger.info("engine ready on %s: %s", device, mode)
    mh = None
    if multihost:
        import atexit

        import torch.distributed as dist

        from ..retrieval.multihost import MultiHostRetrieval, MultiHostSearch

        rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
        mh = MultiHostSearch(engine.clip_retriever, batch=mh_batch)
        if not mh.is_coordinator:
            logger.info("multihost follower (process %d/%d): joining lockstep serving", rank, world)
            served = mh.serve()
            logger.info("multihost follower done after %d searches", served)
            return
        logger.info("multihost coordinator: corpus sharded over %d processes", world)
        engine.clip_retriever = MultiHostRetrieval(mh)
        # release the followers however the coordinator exits (stop() is idempotent)
        atexit.register(mh.stop)
    if opts.warmup:
        n, secs = warm_engine(engine, cfg, opts.warmup, image=opts.port is not None)
        logger.info("warmed %d searches for batch sizes %s in %.1fs", n, opts.warmup, secs)

    if opts.port is not None:
        server = make_http_server(engine, cfg, store_path, opts, mh=mh)
        logger.info("serving HTTP on %s:%d (/search, /search_image, /documents, /snapshot, /healthz, /metrics)",
                    *server.address)
        # SIGTERM: the handler only asks serve_forever to return (shutdown()
        # called from this thread's signal frame would deadlock, so a helper
        # thread calls it); the full close, socket and batcher drain, then
        # runs on the main thread, which keeps the process alive until the
        # drain completes
        import signal
        import threading

        def _stop(signum, frame):
            logger.info("signal %d: draining and shutting down", signum)
            threading.Thread(target=server.request_shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _stop)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.close()
            if mh is not None:
                mh.stop()
        return

    def answer_batch(qs) -> None:
        # a configured fusion head (--fusion.head_params) takes over scoring;
        # otherwise the reference's linear blend
        if engine.fusion_head is not None:
            batches = engine.retrieve_text_fused_batch(qs)
        elif engine.t2s_retriever:
            batches = engine.retrieve_text_batch(qs)
        else:
            batches = engine.retrieve_text_noknowledge_batch(qs)
        for q, results in zip(qs, batches):
            print(json.dumps({"query": q, "results": results[:20]}, indent=2))

    try:
        if query is not None:
            answer_batch([query])
            return
        if batch_mode:
            queries = [line.strip() for line in sys.stdin if line.strip()]
            if queries:
                answer_batch(queries)
            return
        for line in sys.stdin:
            if line.strip():
                answer_batch([line.strip()])
    finally:
        if mh is not None:
            mh.stop()


if __name__ == "__main__":
    main()
