"""Serving entry point: knowledge-enhanced retrieval queries on one device.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/serve.py``
for the ``--query`` and ``--batch`` modes: load a precomputed embedding
store, build the text tower (checkpoint or seeded weights), wire the
Text2SPARQL retriever when its endpoints are configured, and answer:

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.serve \
        --store=data/embeddings/store.npz --model.name=ViT-L/14 \
        --eval.encoder=int8 --eval.quantize_corpus=int8 \
        [--device=cuda] [--query="madonna and child" | --batch < queries.txt]

``--device`` defaults to ``cuda`` and never falls back: serving on the CPU
(the kernels' plain versions) takes ``--device=cpu``.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import (
    Endpoints,
    config_from_argv,
    resolve_encoder,
    resolve_quantize_corpus,
)

from ..data.tokenizer import CLIPTokenizer
from ..models.clip import TextTransformer, build_text_model
from ..models.convert import load_openai_state_dict
from ..ops.dispatch import has_cuda
from ..retrieval.clip_retrieval import CLIPRetrieval
from ..retrieval.embedding_store import EmbeddingStore
from ..retrieval.engine import RetrievalEngine

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# entry-point flags of the JAX CLI that this port does not serve yet
_NOT_PORTED_FLAGS = {
    "--http": "A5 (serving shell: HTTP daemon)",
    "--http-host": "A5 (serving shell: HTTP daemon)",
    "--max-pending": "A5 (serving shell: HTTP daemon)",
    "--cache-results": "A5 (serving shell: HTTP daemon)",
    "--warmup": "A5 (serving shell: warmup)",
    "--bucket-queries": "A5 (serving shell: MicroBatcher)",
    "--multihost": "A8 (parallel modes)",
    "--multihost-batch": "A8 (parallel modes)",
}


def pop_flag(args, flag: str, default=None):
    """Remove ``--flag value`` or ``--flag=value`` from ``args``; return value."""
    prefix = flag + "="
    for i, tok in enumerate(args):
        if tok == flag:
            if i + 1 >= len(args):
                raise ValueError(f"{flag} requires a value")
            val = args[i + 1]
            del args[i : i + 2]
            return val
        if tok.startswith(prefix):
            del args[i]
            return tok[len(prefix):]
    return default


def _load_state_dict(path: str):
    """OpenAI-layout state dict (``.pt`` or ``.npz``) as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            sd = {k: data[k] for k in data.files}
        if any("/" in k for k in sd):
            raise ValueError(
                f"{path} holds a flax parameter tree; export it to the OpenAI layout "
                "(models.convert.save_openai_pt in the JAX package) to serve it here"
            )
        return sd
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, torch.jit.ScriptModule):
        obj = obj.state_dict()
    for key in ("model_state_dict", "state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {
        (k[len("module."):] if k.startswith("module.") else k): v.detach().float().numpy()
        for k, v in obj.items()
        if hasattr(v, "detach")
    }


def build_model(cfg, device) -> TextTransformer:
    """The text tower from ``model.checkpoint`` or, without one, seeded weights."""
    if cfg.model.adapters:
        raise NotImplementedError("--model.adapters (LoRA merge) is not ported yet: ROADMAP A7 (training)")
    dtype = _DTYPES[cfg.model.dtype]
    if cfg.model.checkpoint:
        return load_openai_state_dict(_load_state_dict(cfg.model.checkpoint), device=device, dtype=dtype)
    return build_text_model(cfg.model.name, dtype=dtype, seed=0, device=device)


def build_engine(cfg, store_path: str, device, kg_path: str = "") -> RetrievalEngine:
    if cfg.eval.mmap_store:
        raise NotImplementedError("--eval.mmap_store is not ported yet: ROADMAP A5 (serving shell)")
    if cfg.eval.compile_cache:
        raise NotImplementedError("--eval.compile_cache is a JAX executable cache; the port runs eagerly")
    if cfg.fusion.head_params:
        raise NotImplementedError("--fusion.head_params is not ported yet: ROADMAP A6 (eval and fusion)")
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
        rerank=cfg.eval.rerank,
        truncate_dim=cfg.eval.truncate_dim,
        rotate=cfg.eval.rotate,
        pq_m=cfg.eval.pq_m,
        pq_aniso_t=cfg.eval.pq_aniso_t,
    )
    t2s = None
    env = Endpoints.from_env()
    has_kg = bool(kg_path) or bool(env.sparql_endpoint)
    if has_kg and env.mistral_api_key and env.mistral_agent_id:
        from knowledge_enhanced_multimodal_retrieval_tpu.knowledge.circuit import (
            CachedRetrieval,
            CircuitBreakerRetrieval,
        )
        from knowledge_enhanced_multimodal_retrieval_tpu.knowledge.clients import (
            HTTPSparqlClient,
            MistralAgentClient,
        )
        from knowledge_enhanced_multimodal_retrieval_tpu.knowledge.text2sparql import Text2SparqlRetrieval

        if kg_path:
            from knowledge_enhanced_multimodal_retrieval_tpu.knowledge.kg import LocalKGSparqlClient

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


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not has_cuda():
        raise RuntimeError(
            f"--device={name} but PyTorch sees no CUDA device; "
            "pass --device=cpu to serve with the kernels' plain versions"
        )
    return device


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
