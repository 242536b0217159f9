"""IVF probe against the brute-force scan at scale.

Counterpart of the reference's ``scripts/profile_ivf.py``. The IVF win is
low-batch serving on big corpora: a probe reads ``nprobe * cap / N`` of
the corpus a query, so when ``batch x probed fraction < 1`` it reads less
than one brute pass. On a clustered seeded corpus of ``--n`` x ``--d`` rows
per tower (256 blobs), ``--batch`` queries, k = ``--k``, alpha 0.5:

- ``brute int8``: B2 q8 over the whole int8 corpus;
- ``ivf int8 nprobe=P`` at ``--nprobe`` and 4x it, and ``ivf-pq
  nprobe=P``: ``retrieval.ann.ivf_search`` over an index of ``--nlist``
  lists (k-means on ``--device``, packing on the host). The probe is plain
  PyTorch (a centroid product, a gather of the probed lists, a batched
  product or LUT walk, ``topk``): it launches no kernel of the port.

Each line: event and device-only medians (``scripts.timing``), recall@10
against the exact f32 blend, the speed-up over the brute scan and the
kernel launches of one call; each build: wall seconds, capacity, spill
fraction and probed fraction.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_ivf \
        [--n 262144] [--batch 8] [--repeats 7] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..cli.common import resolve_device
from ..ops.similarity import fused_similarity_topk_q8, quantize_corpus_host
from ..retrieval.ann import build_ivf_index, ivf_search, probed_fraction
from .scale_bench import exact_topk, recall_at
from .timing import card, default_out, launches_of, ms_of, time_ms, write_json

DEFAULT_OUT = default_out("profile_ivf.json")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=262144)
    p.add_argument("--d", type=int, default=768)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nlist", type=int, default=512)
    p.add_argument("--nprobe", type=int, default=16)
    p.add_argument("--repeats", type=int, default=7, help="timed calls a line (medians)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    centers = norm(rng.standard_normal((256, args.d)))
    which = rng.integers(0, 256, args.n)
    img = norm(centers[which] + 0.1 * rng.standard_normal((args.n, args.d), dtype=np.float32))
    txt = norm(centers[which] + 0.1 * rng.standard_normal((args.n, args.d), dtype=np.float32))
    q32 = norm(rng.standard_normal((args.batch, args.d)))
    q = torch.as_tensor(q32, device=dev)
    exact_ids = exact_topk(q32, img, txt, 0.5, args.k, dev)
    print(f"corpus {args.n} x {args.d}, batch {args.batch}, k {args.k}", flush=True)

    lines, builds = {}, {}

    def line(name, fn):
        t = time_ms(fn, dev, iters=args.repeats)
        lines[name] = {**t, "recall@10": recall_at(fn()[1].cpu().numpy(), exact_ids, min(10, args.k)),
                       "launches": launches_of(fn, dev)}
        print(f"{name:24s} " + " ".join(f"{key} {v:8.3f}" for key, v in t.items())
              + f"  recall@10 {lines[name]['recall@10']:.4f}", flush=True)
        return t

    c8 = [torch.as_tensor(a, device=dev) for a in (*quantize_corpus_host(img), *quantize_corpus_host(txt))]
    brute = line("brute int8", lambda: fused_similarity_topk_q8(q.bfloat16(), *c8, args.k, alpha=0.5))
    del c8

    for quant, probes in (("int8", (args.nprobe, 4 * args.nprobe)), ("pq", (args.nprobe,))):
        t0 = time.perf_counter()
        index = build_ivf_index(img, txt, args.nlist, quantize=quant, seed=1, device=dev)
        builds[quant] = {"build_s": time.perf_counter() - t0, "cap": index.cap, "spill": index.spill_fraction,
                         "probed_fraction": probed_fraction(index, args.nprobe)}
        print(f"ivf {quant} build: {builds[quant]['build_s']:.1f} s cap={index.cap} spill={index.spill_fraction:.3f} "
              f"probed_fraction={builds[quant]['probed_fraction']:.4f}", flush=True)
        for nprobe in probes:
            nprobe = min(nprobe, index.nlist)
            t = line(f"ivf {quant} nprobe={nprobe}",
                     lambda index=index, nprobe=nprobe: ivf_search(q, index, k=args.k, nprobe=nprobe, alpha=0.5))
            lines[f"ivf {quant} nprobe={nprobe}"]["speedup_vs_brute"] = ms_of(brute) / ms_of(t)
        del index

    payload = {"script": "profile_ivf", "device": str(dev), "card": card(dev), "n": args.n, "d": args.d,
               "batch": args.batch, "k": args.k, "nlist": args.nlist, "repeats": args.repeats, "lines": lines,
               "builds": builds}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
