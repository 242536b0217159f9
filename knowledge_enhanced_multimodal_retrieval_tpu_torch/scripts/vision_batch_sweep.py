"""Vision-tower encode throughput against batch size.

Counterpart of the reference's ``scripts/vision_batch_sweep.py``: the
corpus-precompute loop (the reference's evaluator hot loop 1) encodes
images in batches, and embed + pool and the per-layer launches amortize
with the batch. Times ``encode_image_fast`` with the int8 plan (B1 a
layer) and, with ``--bf16``, the bf16 plan (B3a + B3b a layer) of a seeded
``--model`` at each batch of ``--batches``: the median over ``--medians``
runs of each run's event and device-only medians (``scripts.timing``,
``--iters`` calls a run), and images/s from the event median.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.vision_batch_sweep \
        [--model ViT-L/14] [--batches 64,128,256] [--bf16] [--medians 5] [--device cuda] [--out PATH]

The JSON goes to ``--out`` (default ``chiprun_out/vision_sweep.json``).
``--quick`` runs a tiny registered arch at batches 4 and 8.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from ..cli.common import resolve_device
from ..models import clip as M
from ..models.fast_encode import encode_image_fast, make_vision_plan
from .timing import card, default_out, launches_of, ms_of, time_ms, write_json

DEFAULT_OUT = default_out("vision_sweep.json")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--batches", default="64,128,256")
    p.add_argument("--bf16", action="store_true", help="also sweep the bf16 tower")
    p.add_argument("--medians", type=int, default=5)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.quick:
        M.ARCHS.setdefault("bench-tiny", M.CLIPArch(16, 32, 1, 32, 16, 16, 600, 32, 2, 1, vision_heads=2))
        args.model, args.batches, args.medians, args.iters = "bench-tiny", "4,8", 2, 3

    model = M.build_model(args.model, dtype=torch.bfloat16, seed=0, device=dev)
    arch = model.arch
    rng = np.random.default_rng(3)
    quantizations = ["int8"] + (["bf16"] if args.bf16 else [])
    plans = {q: make_vision_plan(model, quantize=None if q == "bf16" else q) for q in quantizations}

    results = {}
    for q in quantizations:
        for b in [int(x) for x in args.batches.split(",")]:
            r = arch.image_resolution
            imgs = torch.as_tensor(rng.standard_normal((b, r, r, 3)).astype(np.float32), device=dev)
            fn = lambda: encode_image_fast(arch, plans[q], imgs)  # noqa: E731
            runs = [time_ms(fn, dev, iters=args.iters) for _ in range(args.medians)]
            med = {key: statistics.median(t[key] for t in runs) for key in runs[0]}
            key = f"{q}@{b}"
            results[key] = {"ms_per_batch": med, "img_per_s": b / ms_of(med) * 1e3,
                            "runs_ms": [ms_of(t) for t in runs], "launches": launches_of(fn, dev)}
            print(f"{key:>10}: " + " ".join(f"{k_} {v:8.3f}" for k_, v in med.items())
                  + f" ms/batch  {results[key]['img_per_s']:8.1f} img/s", flush=True)
    payload = {"script": "vision_batch_sweep", "device": str(dev), "card": card(dev), "model": args.model,
               "medians_of": args.medians, "iters": args.iters, "results": results}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
