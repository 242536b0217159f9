"""Card-versus-CPU evaluation consistency check.

The port's counterpart of the repo's ``scripts/consistency_check.py``: the
f32 ``flax`` evaluation path (the module towers; on the card the attention
kernel B6/B7 serves their attention) must give the same embeddings (cosine
> 0.9999 per row) and the same retrieval metrics on ``--device`` as on the
CPU. Recall metrics move in steps of 100 / N per sample, so one boundary
rank flip from a summation-order difference is allowed, as in the JAX
script.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.consistency_check [--device cuda]

Prints the minimum cosine and each metric on both devices, then
``CONSISTENT`` (exit 0) or ``INCONSISTENT`` (exit 1).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..cli.common import resolve_device
from ..data.datasets import DataPipeline, make_synthetic_source
from ..data.tokenizer import CLIPTokenizer
from ..eval.evaluator import encode_dataset, evaluate_clip_model
from ..models.clip import CLIPArch, build_model

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
COS_BAR = 0.9999


def run_eval(device: torch.device):
    tok = CLIPTokenizer(MERGES)
    arch = CLIPArch(16, 32, 1, 32, 16, 16, tok.vocab_size, 32, 2, 1, vision_heads=2)
    model = build_model("tiny", dtype=torch.float32, seed=0, device=device, arch=arch)
    pipe = DataPipeline(make_synthetic_source(32, image_size=32), tok, image_size=32, context_length=16)
    enc = encode_dataset(model, pipe, batch_size=16)
    return enc, evaluate_clip_model(enc, device=device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cpu":
        print("only the CPU was asked for; nothing to compare")
        return 0
    (enc_a, m_a), (enc_b, m_b) = run_eval(device), run_eval(torch.device("cpu"))
    cos = min(float(np.sum(a * b, axis=1).min()) for a, b in
              ((enc_a.image, enc_b.image), (enc_a.query, enc_b.query), (enc_a.target, enc_b.target)))
    print(f"embedding cosine {device} vs cpu: min={cos:.7f}")
    ok = cos > COS_BAR
    tol = 110.0 / enc_a.image.shape[0]
    for key in m_a:
        diff = abs(m_a[key] - m_b[key])
        limit = tol * (10 if "Mean_Rank" in key else 1)
        ok &= diff <= limit
        print(f"  {key}: {m_a[key]:.4f} vs {m_b[key]:.4f} [{'OK' if diff <= limit else 'MISMATCH'}]")
    print(json.dumps({"min_cosine": cos, "metrics": m_a, "metrics_cpu": m_b, "consistent": bool(ok)}))
    print("CONSISTENT" if ok else "INCONSISTENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
