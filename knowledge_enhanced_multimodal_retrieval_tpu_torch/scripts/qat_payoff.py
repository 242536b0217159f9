"""QAT payoff: does training through the int8 roundings buy serving quality
over plain post-training quantization?

Counterpart of the repo's ``scripts/qat_payoff.py`` on the port: two
identical runs (arch, seed, data, steps) of the contrastive trainer,
``qat=False`` (PTQ) and ``qat=True``, each deployed through the same int8
serving plans (``models.fast_encode``, ``quantize="int8"``: kernel B1 on the
card, its plain version on the CPU). Width-64, 4-layer towers, f32
parameters and compute in training. Reported per run, with the JAX script's
keys:

- ``score_mae`` / ``score_max_err``: |int8 blended score - the run's own f32
  blended score| over the query x corpus matrix;
- ``recall10_vs_f32``: overlap@10 of the int8 ranking with the run's f32 one;
- ``recall10_truth_f32`` / ``recall10_truth_int8``: recall@10 of each
  query's own pair;
- ``final_loss_mean5``, ``first_loss``, ``steps``.

The claim is the delta between the runs (``delta_qat_minus_ptq``).

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.qat_payoff \
        [--pairs 256] [--epochs 12] [--batch 32] [--quick] [--device cuda] \
        [--out chiprun_out/qat_payoff.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import tempfile

import numpy as np
import torch

from ..cli.common import resolve_device
from ..data.datasets import DataPipeline, make_synthetic_source
from ..data.tokenizer import CLIPTokenizer
from ..models import clip as M
from ..models.clip import l2_normalize
from ..models.fast_encode import encode_image_fast, encode_text_fast, make_text_plan, make_vision_plan
from ..train.trainer import CLIPTrainer
from ..utils.config import TrainConfig
from .timing import card, default_out, write_json

DEFAULT_OUT = default_out("qat_payoff.json")
MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l"), ("l", "o")]


def _recall_at(ids, truth, k=10):
    return float(np.mean([truth[i] in set(ids[i, :k].tolist()) for i in range(len(truth))]))


def _overlap_at(ids_a, ids_b, k=10):
    return float(np.mean([len(set(ids_a[i, :k].tolist()) & set(ids_b[i, :k].tolist())) / k
                          for i in range(ids_a.shape[0])]))


def payoff_arch(vocab_size: int) -> M.CLIPArch:
    """Width-64, 4-layer towers: quick to train, wide enough that int8
    rounding is not pure noise (the JAX script's arch)."""
    return M.CLIPArch(embed_dim=64, image_resolution=32, vision_layers=4, vision_width=64, vision_patch_size=16,
                      context_length=32, vocab_size=vocab_size, text_width=64, text_heads=4, text_layers=4,
                      vision_heads=4)


def train_run(arch, pipe, args, qat: bool, device):
    """One run of ``args.epochs`` passes over the pairs in a seeded order:
    (model, losses, the mean of the last 5)."""
    model = M.build_model("", arch=arch, dtype=torch.float32, seed=0, device=device)
    with tempfile.TemporaryDirectory() as td:
        cfg = TrainConfig(batch_size=args.batch, epochs=args.epochs, lr=args.lr, qat=qat, warmup_steps=5, seed=0,
                          checkpoint_dir=f"{td}/ckpt")
        trainer = CLIPTrainer(model, pipe, None, cfg, out_dir=td)
        order = np.arange(args.pairs)
        losses = []
        step_rng = np.random.default_rng(0)
        for _ in range(args.epochs):
            step_rng.shuffle(order)
            for i in range(0, args.pairs - args.batch + 1, args.batch):
                db = trainer._device_batch(pipe.make_batch(order[i : i + args.batch].tolist()))
                trainer.state, metrics = trainer.train_step(trainer.state, db)
                losses.append(float(metrics["loss"]))
    return model, losses, statistics.mean(losses[-5:])


@torch.no_grad()
def eval_run(model, pipe, args, device):
    """Serving-quality metrics of one trained model: the module's f32 towers
    against its int8 serving plans, over every pair."""
    batch = pipe.make_batch(list(range(args.pairs)))
    images = torch.from_numpy(batch.images).to(device)
    q_ids, t_ids = (torch.from_numpy(x).to(device) for x in (batch.query_ids, batch.target_ids))
    host = lambda x: l2_normalize(x).float().cpu().numpy()  # noqa: E731
    q32, t32, i32 = host(model.encode_text(q_ids)), host(model.encode_text(t_ids)), host(model.encode_image(images))
    tplan, vplan = make_text_plan(model, quantize="int8"), make_vision_plan(model, quantize="int8")
    arch = model.arch
    q8, t8 = host(encode_text_fast(arch, tplan, q_ids)), host(encode_text_fast(arch, tplan, t_ids))
    i8 = host(encode_image_fast(arch, vplan, images))
    a = args.alpha
    s32 = a * (q32 @ i32.T) + (1 - a) * (q32 @ t32.T)
    s8 = a * (q8 @ i8.T) + (1 - a) * (q8 @ t8.T)
    ids32, ids8 = np.argsort(-s32, axis=1), np.argsort(-s8, axis=1)
    truth = np.arange(args.pairs)
    return {
        "score_mae": round(float(np.mean(np.abs(s8 - s32))), 5),
        "score_max_err": round(float(np.max(np.abs(s8 - s32))), 5),
        "recall10_vs_f32": round(_overlap_at(ids8, ids32), 4),
        "recall10_truth_f32": round(_recall_at(ids32, truth), 4),
        "recall10_truth_int8": round(_recall_at(ids8, truth), 4),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=256)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--quick", action="store_true", help="48 pairs, 2 epochs, batch 16 (control flow)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    if args.quick:
        args.pairs, args.epochs, args.batch = 48, 2, 16
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    tok = CLIPTokenizer(MERGES)
    arch = payoff_arch(tok.vocab_size)
    pipe = DataPipeline(make_synthetic_source(args.pairs, image_size=32), tok, image_size=32, context_length=32,
                        num_workers=1)
    out = {}
    for name, qat in (("ptq", False), ("qat", True)):
        print(f"== training run: {name} (qat={qat}) ==", flush=True)
        model, losses, tail = train_run(arch, pipe, args, qat, device)
        metrics = eval_run(model, pipe, args, device)
        metrics.update(final_loss_mean5=round(tail, 4), first_loss=round(losses[0], 4), steps=len(losses))
        out[name] = metrics
        print(json.dumps({name: metrics}), flush=True)
    delta = {
        "score_mae_change": round(out["qat"]["score_mae"] - out["ptq"]["score_mae"], 5),
        "recall10_vs_f32_change": round(out["qat"]["recall10_vs_f32"] - out["ptq"]["recall10_vs_f32"], 4),
        "recall10_truth_int8_change": round(out["qat"]["recall10_truth_int8"] - out["ptq"]["recall10_truth_int8"], 4),
        "final_loss_change": round(out["qat"]["final_loss_mean5"] - out["ptq"]["final_loss_mean5"], 4),
    }
    payload = {
        "metric": "QAT vs PTQ int8 serving quality (tiny CLIP, synthetic pairs)",
        "backend": device.type,
        "device": card(device) or "cpu",
        "config": {"pairs": args.pairs, "epochs": args.epochs, "batch": args.batch, "lr": args.lr},
        "runs": out,
        "delta_qat_minus_ptq": delta,
    }
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
