"""Break the text-search program down: encode vs blended top-k scan.

Counterpart of the reference's ``scripts/profile_serving.py``. A seeded
CLIP text tower (``--model``, ViT-L/14 by default) encodes ``--batch``
queries of 8-30 random tokens trimmed to their length bucket (the
reference benchmark's serving queries), and the scan runs over a seeded
``--corpus`` x embed_dim corpus per tower, k = ``--k``. Seven lines:

- ``encode_only`` / ``encode_q8``: ``encode_text_fast`` with the bf16
  plan (B3a + B3b a layer) / the int8 plan (B1 a layer), L2-normalized;
- ``topk_only`` / ``topk_q8c``: B2 over the bf16 / int8 corpus from fixed
  bf16 queries;
- ``full`` / ``full_q8`` / ``full_q8_q8c``: encode then scan (bf16 plan +
  bf16 corpus, int8 plan + bf16 corpus, int8 plan + int8 corpus).

Each line: event and device-only medians (``scripts.timing``), queries/s
from the event median, and the kernel launches of one call.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_serving \
        [--batch 256] [--corpus 43000] [--k 20] [--iters 30] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli.common import resolve_device
from ..data.tokenizer import trim_to_bucket
from ..models import clip as M
from ..models.fast_encode import encode_text_fast, make_text_plan
from ..ops.similarity import fused_similarity_topk, fused_similarity_topk_q8, quantize_corpus_host
from .timing import card, default_out, launches_of, ms_of, time_ms, write_json

DEFAULT_OUT = default_out("profile_serving.json")


def serving_ids(arch, batch: int, rng: np.random.Generator) -> np.ndarray:
    """``batch`` queries of 8-30 random tokens between SOT and EOT, trimmed
    to their length bucket."""
    ids = np.zeros((batch, arch.context_length), np.int64)
    lengths = rng.integers(8, 31, batch)
    ids[:, 0] = arch.vocab_size - 2
    for i, n in enumerate(lengths):
        ids[i, 1 : 1 + n] = rng.integers(1, arch.vocab_size - 2, n)
        ids[i, 1 + n] = arch.vocab_size - 1
    return trim_to_bucket(ids)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--corpus", type=int, default=43_000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    model = M.build_model(args.model, dtype=torch.bfloat16, seed=0, device=dev)
    arch = model.arch
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(serving_ids(arch, args.batch, rng), device=dev)

    def unit(n):
        x = rng.standard_normal((n, arch.embed_dim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    img, txt = unit(args.corpus), unit(args.corpus)
    cimg, ctxt = (torch.as_tensor(x, device=dev).bfloat16() for x in (img, txt))
    q8 = [torch.as_tensor(a, device=dev) for a in (*quantize_corpus_host(img), *quantize_corpus_host(txt))]
    q_fixed = M.l2_normalize(torch.as_tensor(unit(args.batch), device=dev)).bfloat16()
    plan, plan_q8 = make_text_plan(model), make_text_plan(model, quantize="int8")
    k = args.k

    def encode(pl):
        return M.l2_normalize(encode_text_fast(arch, pl, ids)).bfloat16()

    lines = {
        "encode_only": lambda: encode(plan),
        "topk_only": lambda: fused_similarity_topk(q_fixed, cimg, ctxt, k, alpha=0.5),
        "topk_q8c": lambda: fused_similarity_topk_q8(q_fixed, *q8, k, alpha=0.5),
        "full": lambda: fused_similarity_topk(encode(plan), cimg, ctxt, k, alpha=0.5),
        "encode_q8": lambda: encode(plan_q8),
        "full_q8": lambda: fused_similarity_topk(encode(plan_q8), cimg, ctxt, k, alpha=0.5),
        "full_q8_q8c": lambda: fused_similarity_topk_q8(encode(plan_q8), *q8, k, alpha=0.5),
    }
    results = {}
    for name, fn in lines.items():
        t = time_ms(fn, dev, iters=args.iters)
        results[name] = {**t, "q_per_s": args.batch / ms_of(t) * 1e3, "launches": launches_of(fn, dev)}
        print(f"{name:12s} " + " ".join(f"{key} {v:8.3f}" for key, v in t.items())
              + f"  ({results[name]['q_per_s']:9.1f} q/s)", flush=True)
    payload = {"script": "profile_serving", "device": str(dev), "card": card(dev), "model": args.model,
               "corpus": args.corpus, "batch": args.batch, "k": k, "seq_bucket": int(ids.shape[1]),
               "iters": args.iters, "lines": results}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
