"""Where a parallel training step's time and memory go: DP and FSDP over the visible cards of one process.

Each layout (``dp``: data parallel, ``fsdp``: the GSPMD step over FSDP
blocks) trains a seeded ``--model`` at ``--batch`` random images and token
ids over ``--shards`` data shards, one a card when that many cards are
visible, else the first card repeated; one warm-up step (it builds AdamW's
state), then ``--steps`` timed steps, each synchronized on every card
(host clock). Per layout: the steps' ms and their median, each card's peak
(``max_memory_allocated`` over the warm-up and the timed steps) and, for
FSDP, the most built at once (``ShardedParams.gauge``). ``--profile`` adds
a ``torch.profiler`` table of one more FSDP step: self CPU time and CUDA
time by operator. On the CPU (``--device=cpu``) the script runs over
``[cpu] * shards`` to check the control flow; no device metric is taken.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_parallel \
        [--model ViT-L/14] [--batch 64] [--shards 4] [--steps 3] [--profile] [--quick] \
        [--device cuda] [--out chiprun_out/profile_parallel.json]
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from ..cli.common import resolve_device
from ..models import clip as M
from ..parallel.mesh import MeshRuntime
from ..train import trainer as TT
from ..utils.config import MeshConfig, TrainConfig
from .timing import card, default_out, write_json
from .train_bench import QUICK_ARCH, _ids

DEFAULT_OUT = default_out("profile_parallel.json")


def _devices(dev: torch.device, shards: int) -> list:
    if dev.type == "cuda" and torch.cuda.device_count() >= shards:
        return [torch.device("cuda", i) for i in range(shards)]
    return [dev] * shards


def _sync(devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_layout(base: M.CLIP, layout: str, batch: dict, devices: list, steps: int, profile: bool) -> dict:
    cfg = TrainConfig(batch_size=batch["images"].shape[0], global_negatives=True)
    rt = MeshRuntime.create(MeshConfig(data_parallel=len(devices), fsdp=layout == "fsdp"), devices)
    model = copy.deepcopy(base)
    if rt.fsdp:
        state = TT.init_state_fsdp(model, cfg, rt, 1)
        step = TT.make_train_step_gspmd(model, cfg, rt, state.layout)
    else:
        state = TT.TrainState(model, TT.make_optimizer(cfg, 1, model))
        step = TT.make_train_step(model, cfg, rt=rt)
    shards = TT.as_row_shards(batch, rt)
    cards = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    state, _ = step(state, shards)
    times, losses = [], []
    for _ in range(steps):
        _sync(devices)
        t0 = time.perf_counter()
        state, met = step(state, shards)
        _sync(devices)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    out = {"step_ms": times, "median_ms": float(np.median(times)), "losses": losses,
           "peak_bytes": [torch.cuda.max_memory_allocated(d) for d in cards]}
    if state.layout is not None:
        out["built_peak_bytes"] = state.layout.gauge.peak
    if profile and rt.fsdp:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
        with torch_profile(activities=activities) as prof:
            state, _ = step(state, shards)
            _sync(devices)
        table = prof.key_averages()
        out["profile"] = table.table(sort_by="self_cpu_time_total", row_limit=30, max_name_column_width=60)
        if cards:
            out["profile_cuda"] = table.table(sort_by="cuda_time_total", row_limit=15, max_name_column_width=60)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--profile", action="store_true", help="a torch.profiler table of one FSDP step")
    p.add_argument("--quick", action="store_true", help="a tiny arch at batch 8 (control flow only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    arch = QUICK_ARCH if args.quick else M.ARCHS[args.model]
    b = 8 if args.quick else args.batch
    devices = _devices(dev, args.shards)
    base = M.build_model(args.model, dtype=torch.bfloat16, seed=0, device=devices[0], arch=arch)
    rng = np.random.default_rng(0)
    r, length = arch.image_resolution, arch.context_length
    batch = {"images": torch.from_numpy(rng.standard_normal((b, r, r, 3)).astype(np.float32)),
             "query_ids": torch.from_numpy(_ids(rng, b, length, arch.vocab_size)),
             "target_ids": torch.from_numpy(_ids(rng, b, length, arch.vocab_size))}
    layouts = {}
    for layout in ("dp", "fsdp"):
        layouts[layout] = run_layout(base, layout, batch, devices, args.steps, args.profile)
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                with torch.cuda.device(d):
                    torch.cuda.empty_cache()
        print(layout, {k: v for k, v in layouts[layout].items() if not k.startswith("profile")}, flush=True)
        for key in ("profile", "profile_cuda"):
            if key in layouts[layout]:
                print(layouts[layout][key], flush=True)
    result = {"device": card(dev) or "cpu", "model": "quick" if args.quick else args.model, "batch": b,
              "devices": [str(d) for d in devices], "layouts": layouts}
    write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
