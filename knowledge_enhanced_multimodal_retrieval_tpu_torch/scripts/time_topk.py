"""Time the blended top-k kernels across k on one GPU.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.time_topk [--b5-k 20,128,400]
        [--b2-k 20,128,400,513,1000]

Prints the card's name, power limit and top SM clock, then the device-only
time (median of 10 CUDA-event intervals, the card kept busy while the host
enqueues) of:

- B5 (``ops.pq.pq_adc_topk``, M = 96, K = 256, Q = 256, random LUTs and
  codes) at 43,000 and 1,000,000 rows and each k of ``--b5-k``, with its
  results held bit for bit to the plain version at 43,000 rows;
- B2 (``ops.similarity.fused_similarity_topk{,_q8,_q4}``, Q = 256 over
  43,000 x 768 per tower) at each k of ``--b2-k`` (above 512 in passes),
  with the largest difference from the plain top-k values;
- the LUT re-layout B5's wrapper makes (``pq_lut_interleave``).

It needs a CUDA device and exits with code 1 without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..ops import dispatch
from ..ops import pq as PQ
from ..ops import similarity as S


def device_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b5-k", default="20,128,400", help="comma-separated k for B5")
    ap.add_argument("--b2-k", default="20,128,400,513,1000", help="comma-separated k for B2")
    args = ap.parse_args(argv)
    b5_ks = [int(x) for x in args.b5_k.split(",")]
    b2_ks = [int(x) for x in args.b2_k.split(",")]
    if not torch.cuda.is_available():
        print("time_topk: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    dispatch.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    qn, m, n_k = 256, 96, 256
    for n in (43_000, 1_000_000):
        luts = [(0.05 * torch.randn((m, qn, n_k), device=dev, generator=gen)).bfloat16() for _ in range(2)]
        codes = [torch.randint(0, n_k, (n, m), dtype=torch.uint8, device=dev, generator=gen) for _ in range(2)]
        scales = [0.5 + torch.rand((n, 1), device=dev, generator=gen) for _ in range(2)]
        alpha = 0.2 + 0.6 * torch.rand((qn, 1), device=dev, generator=gen)
        pq_args = (alpha, luts[0], luts[1], codes[0], scales[0], codes[1], scales[1])
        for k in b5_ks:
            got = PQ.pq_adc_topk(*pq_args, k)
            if n == 43_000:
                want = S.topk_plain(PQ.blended_adc_from_luts(*pq_args), k)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"B5 at {n} rows, k = {k}: not bit-equal to its plain version")
            print(f"B5 rows {n} k {k}: device ms {device_ms(lambda: PQ.pq_adc_topk(*pq_args, k)):.4f}", flush=True)
        del luts, codes, scales, pq_args
    lut = (0.05 * torch.randn((m, qn, n_k), device=dev, generator=gen)).bfloat16()
    print(f"pq_lut_interleave [{m}, {qn}, {n_k}]: device ms {device_ms(lambda: PQ.pq_lut_interleave(lut)):.4f}")

    rng = np.random.default_rng(0)
    n, d = 43_000, 768

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)

    img, txt = unit(rng.standard_normal((n, d))), unit(rng.standard_normal((n, d)))
    qs = torch.tensor(unit(rng.standard_normal((qn, d))), device=dev).bfloat16()
    alpha = torch.tensor(rng.uniform(0.2, 0.8, qn), dtype=torch.float32, device=dev)
    modes = {"exact": ((torch.tensor(img, device=dev).bfloat16(), torch.tensor(txt, device=dev).bfloat16()),
                       S.fused_similarity_topk, S.blended_scores)}
    for mode, quant, fused, plain in (("q8", S.quantize_corpus_host, S.fused_similarity_topk_q8, S.blended_scores_q8),
                                      ("q4", S.quantize_corpus_host_q4, S.fused_similarity_topk_q4, S.blended_scores_q4)):
        (iq, is_), (tq, ts) = quant(img), quant(txt)
        modes[mode] = (tuple(torch.tensor(x, device=dev) for x in (iq, is_, tq, ts)), fused, plain)
    for k in b2_ks:
        for mode, (c, fused, plain) in modes.items():
            got = fused(qs, *c, k, alpha=alpha)
            err = float((got[0] - S.topk_plain(plain(qs, *c, alpha), k)[0]).abs().max())
            ms = device_ms(lambda: fused(qs, *c, k, alpha=alpha))
            print(f"B2 {mode} k {k}: device ms {ms:.4f}, max abs err {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
