"""Serving entry point: knowledge-enhanced retrieval queries on one device.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/serve.py``
for the ``--query`` and ``--batch`` modes: load a precomputed embedding
store, build the CLIP towers (checkpoint or seeded weights), wire the
Text2SPARQL retriever when its endpoints are configured, and answer:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.serve \
        --store=data/embeddings/store.npz --model.name=ViT-L/14 \
        --eval.encoder=int8 --eval.quantize_corpus=int8 \
        [--device=cuda] [--query="madonna and child" | --batch < queries.txt]

The capacity tiers take the JAX CLI's flags: ``--eval.quantize_corpus=
int4|pq|binary``, ``--eval.pq_m``, ``--eval.pq_aniso_t``, ``--eval.rotate``
with ``--eval.rotate_mode=random|opq`` and ``--eval.rotate_seed``,
``--eval.truncate_dim``, ``--eval.rerank`` with ``--eval.rerank_factor``,
and ``--eval.ann=ivf`` with ``--eval.ann_nlist``, ``--eval.ann_nprobe``,
``--eval.ann_index`` (an index cache, e.g. from ``cli.index``) and
``--eval.ann_max_batch_lookups``.

``--device`` defaults to ``cuda`` and never falls back: serving on the CPU
(the kernels' plain versions) takes ``--device=cpu``.
"""

from __future__ import annotations

import json
import sys

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
from .common import build_model, pop_flag, resolve_device

# entry-point flags of the JAX CLI that this port does not serve yet
_NOT_PORTED_FLAGS = {
    "--http": "A2 (serving shell: HTTP daemon)",
    "--http-host": "A2 (serving shell: HTTP daemon)",
    "--max-pending": "A2 (serving shell: HTTP daemon)",
    "--cache-results": "A2 (serving shell: HTTP daemon)",
    "--warmup": "A2 (serving shell: warmup)",
    "--bucket-queries": "A2 (serving shell: MicroBatcher)",
    "--multihost": "A5 (parallel modes)",
    "--multihost-batch": "A5 (parallel modes)",
}


def build_engine(cfg, store_path: str, device, kg_path: str = "") -> RetrievalEngine:
    if cfg.eval.mmap_store:
        raise NotImplementedError("--eval.mmap_store is not ported yet: ROADMAP A2 (serving shell)")
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    if cfg.fusion.head_params:
        raise NotImplementedError("--fusion.head_params is not ported yet: ROADMAP A3 (eval and fusion)")
    model = build_model(cfg, device)
    tokenizer = CLIPTokenizer.find_default()
    store = EmbeddingStore.load(store_path)
    # eval.encoder: flax (module tower), fast (bf16 fused layers), int8 (W8A8)
    use_fast, quantize = resolve_encoder(cfg.eval.encoder)
    clip_r = CLIPRetrieval(
        model, tokenizer, store,
        device=device,
        use_fused_encoder=use_fast,
        quantize=quantize,
        quantize_corpus=resolve_quantize_corpus(cfg.eval.quantize_corpus),
        capacity_multiple=cfg.eval.capacity_multiple,
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
    return RetrievalEngine(clip_r, t2s, cfg.fusion)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    for flag, item in _NOT_PORTED_FLAGS.items():
        if any(a == flag or a.startswith(flag + "=") for a in args):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP {item}")
    batch_mode = "--batch" in args
    if batch_mode:
        args.remove("--batch")
    store_path = pop_flag(args, "--store", "data/embeddings/store.npz")
    kg_path = pop_flag(args, "--kg", "")
    query = pop_flag(args, "--query")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    cfg = config_from_argv(args)
    engine = build_engine(cfg, store_path, device, kg_path=kg_path)

    def answer_batch(qs) -> None:
        if engine.t2s_retriever:
            batches = engine.retrieve_text_batch(qs)
        else:
            batches = engine.retrieve_text_noknowledge_batch(qs)
        for q, results in zip(qs, batches):
            print(json.dumps({"query": q, "results": results[:20]}, indent=2))

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


if __name__ == "__main__":
    main()
