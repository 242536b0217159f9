"""Train-step throughput of the fine-tuning loop (the reference's only hot loop).

Counterpart of the reference's ``scripts/train_bench.py`` on the port: one
``train.trainer`` step (both towers forward, the joint InfoNCE loss,
backward with the attention gradient recomputed through the plain version,
clipping, AdamW) on a seeded ``--model`` at ``--batch`` random images and
token ids, f32 parameters and bf16 compute, the default ``TrainConfig``.

- ``step_ms``: the median of ``--steps`` (15) dependent steps (each updates the
  parameters the next one reads), CUDA events around each step;
  ``device_ms``: the same median with the card kept busy (a spin of 1.5
  steps) while the host enqueues (``scripts.timing``), so the host's launch
  time drops out.
- FLOPs are counted from the arch (there is no compiled program to ask):
  every projection, MLP and patch-embedding product at 2 operations a
  multiply-add, and the attention scores q.k and p.v over the whole
  sequence (causal included), the text tower once for queries and once for
  targets. A step is 3x the forward, 4x with ``--remat`` (the forward runs
  again in the backward). MFU is against 989 TFLOP/s (the H100 SXM's dense
  bf16 peak at 700 W).
- ``--breakdown`` adds the image tower forward, both text forwards, forward
  + loss and forward + backward for the first entry, and on the card one
  step's device time by kernel name (``torch.profiler``);
  ``--sweep`` runs ViT-L/14 at 64 with and without remat, ViT-L/14@336px at
  64 with remat (577 tokens: B7) and ViT-B/32 at batch 64 / 128 / 256.

On the CPU (``--device=cpu``) the script runs the plain versions to check
the control flow and reports ``host_ms`` only; no device metric is taken.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.train_bench \
        [--model ViT-L/14] [--batch 64] [--steps 15] [--remat] [--sweep] [--breakdown] \
        [--device cuda] [--out chiprun_out/train_bench.json]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..cli.common import resolve_device
from ..models import clip as M
from ..models.clip import l2_normalize
from ..ops import dispatch
from ..train.losses import joint_contrastive_loss
from ..train.trainer import TrainState, make_optimizer, make_train_step
from ..utils.config import TrainConfig
from .timing import card, default_out, sync, time_ms, write_json

DEFAULT_OUT = default_out("train_bench.json")
PEAK_BF16_FLOPS = 989e12
SWEEP = [("ViT-L/14", 64, False), ("ViT-L/14", 64, True), ("ViT-L/14@336px", 64, True),
         ("ViT-B/32", 64, False), ("ViT-B/32", 128, False), ("ViT-B/32", 256, False)]
QUICK_ARCH = M.CLIPArch(16, 32, 1, 32, 16, 16, 600, 32, 2, 1, vision_heads=2)


def forward_flops(arch: M.CLIPArch, batch: int) -> dict:
    """Forward FLOPs of one step's towers by part: ``vision``, ``text``
    (queries and targets) and ``attention`` (the scores of both)."""
    s_v, s_t = arch.grid_size**2 + 1, arch.context_length
    w_v, w_t = arch.vision_width, arch.text_width
    patch = 2 * batch * arch.grid_size**2 * 3 * arch.vision_patch_size**2 * w_v
    vision = patch + arch.vision_layers * 24 * batch * s_v * w_v**2 + 2 * batch * w_v * arch.embed_dim
    text = 2 * (arch.text_layers * 24 * batch * s_t * w_t**2 + 2 * batch * w_t * arch.embed_dim)
    attention = 4 * batch * (arch.vision_layers * s_v**2 * w_v + 2 * arch.text_layers * s_t**2 * w_t)
    return {"vision": vision, "text": text, "attention": attention}


def step_flops(arch: M.CLIPArch, batch: int, remat: bool) -> float:
    return (4 if remat else 3) * sum(forward_flops(arch, batch).values())


def _ids(rng, b: int, length: int, vocab: int) -> np.ndarray:
    """Random token rows: SOT, 3..length-2 tokens, EOT (the largest id), zeros."""
    ids = np.zeros((b, length), np.int32)
    ids[:, 0] = vocab - 2
    n = rng.integers(3, length - 1, b)
    for i, k in enumerate(n):
        ids[i, 1 : 1 + k] = rng.integers(1, vocab - 2, k)
        ids[i, 1 + k] = vocab - 1
    return ids


def _profile_step(step, state, batch, top: int = 15) -> dict:
    """One step under ``torch.profiler`` on the card: device time by kernel
    name (the ``top`` largest, and the rest summed) and the step's device total."""
    from torch.profiler import ProfilerActivity, profile

    sync(batch["images"].device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        sync(batch["images"].device)
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"device_total_ms": total, "kernels": [{"name": n[:120], "ms": t, "calls": c} for n, t, c in rows[:top]],
            "rest_ms": total - sum(r[1] for r in rows[:top])}


def _breakdown(model, batch, dev, iters) -> dict:
    """Nested sections (each includes the one before it)."""
    images, q, t = batch["images"], batch["query_ids"], batch["target_ids"]

    def fwd_loss():
        img = l2_normalize(model.encode_image(images))
        loss, _ = joint_contrastive_loss(img, l2_normalize(model.encode_text(q)), l2_normalize(model.encode_text(t)))
        return loss

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        fwd_loss().backward()

    with torch.no_grad():
        out = {"image_tower_fwd": time_ms(lambda: model.encode_image(images), dev, iters=iters),
               "text_towers_fwd": time_ms(lambda: (model.encode_text(q), model.encode_text(t)), dev, iters=iters),
               "fwd_loss": time_ms(fwd_loss, dev, iters=iters)}
    out["fwd_bwd"] = time_ms(fwd_bwd, dev, iters=iters)
    model.zero_grad(set_to_none=True)
    return out


def run_entry(model_name: str, batch: int, remat: bool, steps: int, dev: torch.device, breakdown: bool = False) -> dict:
    cfg = TrainConfig(batch_size=batch)
    arch = QUICK_ARCH if model_name == "quick" else None
    model = M.build_model(model_name, dtype=torch.bfloat16, seed=0, device=dev, arch=arch, remat=remat)
    arch = model.arch
    state = TrainState(model, make_optimizer(cfg, 100, model))
    step = make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    r, L = arch.image_resolution, arch.context_length
    host = {"images": rng.standard_normal((batch, r, r, 3)).astype(np.float32),
            "query_ids": _ids(rng, batch, L, arch.vocab_size), "target_ids": _ids(rng, batch, L, arch.vocab_size)}
    db = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    extra = _breakdown(model, db, dev, max(3, steps // 3)) if breakdown else None

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = dispatch.launch_counts()
    step(state, db)  # warmup: the kernel library and the optimizer state
    sync(dev)
    launches = {k: v - before[k] for k, v in dispatch.launch_counts().items() if v != before[k]}
    t0 = time.perf_counter()
    step(state, db)
    sync(dev)
    # the device-only spin covers 1.5x a whole step (~2e6 clock cycles a ms)
    spin = int(2e6 * 1.5 * (time.perf_counter() - t0) * 1e3)
    timed = time_ms(lambda: step(state, db), dev, iters=steps, warmup=1, spin_cycles=spin)
    sync(dev)
    if extra is not None and dev.type == "cuda":
        extra["profile"] = _profile_step(step, state, db)
    loss = float(step(state, db)[1]["loss"])
    flops = step_flops(arch, batch, remat)
    entry = {"model": model_name, "batch": batch, "remat": remat, "steps_timed": steps, **timed,
             "loss_final": loss, "forward_flops": forward_flops(arch, batch), "flops_per_step": flops,
             "launches_per_step": launches}
    if dev.type == "cuda":
        entry.update({
            "step_ms": timed["event_ms"], "samples_per_s": batch / timed["event_ms"] * 1e3,
            "mfu": flops / (timed["event_ms"] * 1e-3) / PEAK_BF16_FLOPS,
            "mfu_device": flops / (timed["device_ms"] * 1e-3) / PEAK_BF16_FLOPS,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        })
    if extra:
        entry["breakdown"] = extra
    del state, step, model, db
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return entry


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=15)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--sweep", action="store_true", help="the batch and model ladder (see the module docstring)")
    p.add_argument("--breakdown", action="store_true", help="per-section split of the first entry")
    p.add_argument("--quick", action="store_true", help="a tiny arch at batch 8 (control flow only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if args.quick:
        plan = [("quick", 8, args.remat)]
    elif args.sweep:
        plan = SWEEP
    else:
        plan = [(args.model, args.batch, args.remat)]
    entries = []
    t0 = time.perf_counter()
    for i, (name, batch, remat) in enumerate(plan):
        entry = run_entry(name, batch, remat, args.steps, dev, breakdown=args.breakdown and i == 0)
        print(entry, flush=True)
        entries.append(entry)
    result = {"device": card(dev) or "cpu", "entries": entries, "wall_s": time.perf_counter() - t0,
              "median_note": "median of dependent steps; CUDA events on the card, host clock on the CPU"}
    write_json(result, args.out)
    return result


if __name__ == "__main__":
    main()
