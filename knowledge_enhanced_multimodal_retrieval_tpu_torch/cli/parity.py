"""Real-artifact parity runbook: artifacts in, ``PARITY_RESULTS.json`` out.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/parity.py``.
The real CLIP vocabulary, pretrained checkpoints and the 43k HF corpus
cannot be fetched offline; the day they are on disk, parity against the
reference pipeline (``src/clip/eval/evaluator.py:54`` end to end) is one
command, and its report has the JAX runbook's format key for key:

    CLIP_BPE_PATH=... CLIP_PT_PATH=... [CLIP_HF_PATH=...] \\
    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.parity \\
        --data.dataset=<hf-name-or-local-dir> [--out PARITY_RESULTS.json] [--device cuda]

Stages (each reports ``ok`` / ``skipped`` / ``failed`` independently — a
missing artifact skips its stage, it never aborts the runbook):

1. ``tokenizer``  — real BPE vocab structure, golden token ids, native C++
   vs Python merge-engine agreement.
2. ``converter``  — OpenAI ``.pt`` and/or HF ``CLIPModel`` conversion
   (``models.convert``) with per-modality cosine >= 0.999 of the port's f32
   CLIP on ``--device`` against the torch reference forward: the
   TorchScript archive itself (a raw state dict has none: ``cosine: null``
   with a note) or ``CLIPModel.get_*_features``.
3. ``evaluation`` — full R@K over the dataset with the converted weights
   (``eval.evaluator.run_full_evaluation``, ``--eval.encoder``), per task.

``--dry-run`` substitutes every artifact with in-repo synthetic fakes (a
tiny seeded checkpoint written by ``models.convert.save_openai_pt``,
``synthetic:N`` data) and runs the same three stages end to end.
``--device`` defaults to ``cuda`` and never falls back (``--device=cpu``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.config import config_from_argv
from ..utils.logging_utils import setup_logger
from .common import pop_flag, resolve_device

COSINE_BAR = 0.999  # the converter-parity bar


def _stage(fn: Callable[[], Dict]) -> Dict:
    """Run one stage; normalize to {"status": ..., ...detail}."""
    try:
        out = fn()
        return {"status": "ok", **(out or {})}
    except _Skip as s:
        return {"status": "skipped", "reason": str(s)}
    except Exception as e:  # noqa: BLE001 — the report records, never aborts
        return {
            "status": "failed",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc(limit=8),
        }


class _Skip(Exception):
    """Raised by a stage when its artifact is absent."""


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return (a * b).sum(-1)


# ---------------------------------------------------------------------------
# Stage 1: tokenizer goldens
# ---------------------------------------------------------------------------


def _stage_tokenizer(bpe_path: Optional[str]) -> Dict:
    from ..data.tokenizer import CLIPTokenizer

    if not (bpe_path and os.path.exists(bpe_path)):
        raise _Skip("CLIP_BPE_PATH not set / missing")
    tok = CLIPTokenizer.from_openai_vocab(bpe_path)
    checks = {}
    checks["vocab_size"] = tok.vocab_size == 49408
    checks["specials"] = tok.sot_token == 49406 and tok.eot_token == 49407
    ids = tok("a photo of a cat")[0]
    checks["golden_cat"] = ids[:7].tolist() == [49406, 320, 1125, 539, 320, 2368, 49407]
    ids = tok("a photo of a dog")[0]
    checks["golden_dog"] = ids[:7].tolist() == [49406, 320, 1125, 539, 320, 1929, 49407]
    if tok._native is not None:
        merges = [None] * len(tok.bpe_ranks)
        for pair, rank in tok.bpe_ranks.items():
            merges[rank] = pair
        py = CLIPTokenizer(merges, use_native=False)
        texts = ["a photo of a cat", "ceci n'est pas une pipe", "12,345 œuvres"]
        checks["native_matches_python"] = bool(np.array_equal(tok(texts), py(texts)))
    if not all(checks.values()):
        raise AssertionError(f"tokenizer golden checks failed: {checks}")
    return {"checks": checks}


# ---------------------------------------------------------------------------
# Stage 2: converter cosine parity
# ---------------------------------------------------------------------------


def _forward_pair(sd, device, seed: int = 0):
    """(images, ids, img_emb, txt_emb): the port's CLIP from the
    OpenAI-layout state dict ``sd``, in f32 on ``device``."""
    from ..models.convert import load_openai_state_dict

    model = load_openai_state_dict(sd, device=device, dtype=torch.float32)
    arch = model.arch
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((2, arch.image_resolution, arch.image_resolution, 3)).astype(np.float32)
    ids = np.zeros((2, arch.context_length), np.int32)
    ids[:, 0], ids[:, 1], ids[:, 2] = arch.vocab_size - 2, 320 % (arch.vocab_size - 2), arch.vocab_size - 1
    with torch.no_grad():
        img_emb = model.encode_image(torch.from_numpy(images).to(device)).cpu().numpy()
        txt_emb = model.encode_text(torch.from_numpy(ids).long().to(device)).cpu().numpy()
    return images, ids, img_emb, txt_emb


def _stage_converter_pt(pt_path: Optional[str], device) -> Dict:
    from ..models.convert import load_torch_state_dict, torch_to_openai

    if not (pt_path and os.path.exists(pt_path)):
        raise _Skip("CLIP_PT_PATH not set / missing")
    sd = torch_to_openai(load_torch_state_dict(pt_path))
    images, ids, img_emb, txt_emb = _forward_pair(sd, device)
    out: Dict = {"finite": bool(np.isfinite(img_emb).all() and np.isfinite(txt_emb).all())}
    if not out["finite"]:
        raise AssertionError("converted forward produced non-finite embeddings")
    # full parity when the archive is an executable TorchScript model
    try:
        ts = torch.jit.load(pt_path, map_location="cpu").float().eval()
    except Exception:
        out["cosine"] = None
        out["note"] = "raw state dict: conversion + forward only (no scripted reference)"
        return out
    with torch.no_grad():
        t_img = ts.encode_image(torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
        t_txt = ts.encode_text(torch.from_numpy(ids).long()).numpy()
    ci, ct = float(_cos(img_emb, t_img).min()), float(_cos(txt_emb, t_txt).min())
    out["cosine"] = {"image": ci, "text": ct}
    if min(ci, ct) < COSINE_BAR:
        raise AssertionError(f"cosine parity below {COSINE_BAR}: {out['cosine']}")
    return out


def _hf_features(hf, images: np.ndarray, ids: np.ndarray):
    """``CLIPModel``'s projected image and text features (what
    ``get_image_features`` / ``get_text_features`` compute), built from the
    towers' pooled outputs so that they read alike in transformers 4 (a
    tensor) and 5 (a model output); the text side masks ``ids == 0``."""
    with torch.no_grad():
        vis = hf.vision_model(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2))
        txt = hf.text_model(input_ids=torch.from_numpy(ids).long(),
                            attention_mask=torch.from_numpy((ids != 0).astype(np.int64)))
        return hf.visual_projection(vis.pooler_output).numpy(), hf.text_projection(txt.pooler_output).numpy()


def _stage_converter_hf(hf_path: Optional[str], device) -> Dict:
    if not (hf_path and os.path.isdir(hf_path)):
        raise _Skip("CLIP_HF_PATH not set / missing")
    from transformers import CLIPModel

    from ..models.convert import hf_to_openai, normalize_state_dict

    hf = CLIPModel.from_pretrained(hf_path).float().eval()
    sd = hf_to_openai(normalize_state_dict(hf.state_dict()))
    images, ids, img_emb, txt_emb = _forward_pair(sd, device)
    t_img, t_txt = _hf_features(hf, images, ids)
    ci, ct = float(_cos(img_emb, t_img).min()), float(_cos(txt_emb, t_txt).min())
    if min(ci, ct) < COSINE_BAR:
        raise AssertionError(f"cosine parity below {COSINE_BAR}: image={ci} text={ct}")
    return {"cosine": {"image": ci, "text": ct}}


# ---------------------------------------------------------------------------
# Stage 3: full R@K evaluation
# ---------------------------------------------------------------------------


def _stage_evaluation(cfg, checkpoint: Optional[str], bpe_path: Optional[str], out_dir: str, device) -> Dict:
    from ..data.tokenizer import CLIPTokenizer
    from ..eval.evaluator import run_full_evaluation
    from ..models.convert import load_clip_state_dict, load_openai_state_dict
    from .common import build_model, build_pipeline

    if not cfg.data.dataset:
        raise _Skip("no --data.dataset given")
    synthetic = cfg.data.dataset.startswith("synthetic:")
    if not synthetic and not checkpoint:
        raise _Skip("no checkpoint artifact for a real-data eval (set CLIP_PT_PATH/CLIP_HF_PATH)")

    if checkpoint:
        dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
        model = load_openai_state_dict(load_clip_state_dict(checkpoint), device=device, dtype=dtype)
    else:  # synthetic dry run: the seeded tiny arch
        model = build_model(cfg, device)

    tokenizer = None
    if bpe_path and os.path.exists(bpe_path):
        tokenizer = CLIPTokenizer.from_openai_vocab(bpe_path)
    pipe = build_pipeline(cfg, cfg.data.split_test, tokenizer=tokenizer)
    report = run_full_evaluation(
        model, pipe,
        batch_size=cfg.eval.batch_size,
        k_values=cfg.eval.ks,
        t2i_weight=cfg.eval.t2i_weight,
        t2t_weight=cfg.eval.t2t_weight,
        output_json=os.path.join(out_dir, "parity_eval.json"),
        encoder=cfg.eval.encoder,
    )
    return {
        "num_samples": report["num_samples"],
        "per_task": report["per_task"],
        "weighted": report["weighted"],
    }


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def main(argv=None) -> Dict:
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = pop_flag(args, "--out", "PARITY_RESULTS.json")
    device = resolve_device(pop_flag(args, "--device", "cuda"))
    dry_run = "--dry-run" in args
    if dry_run:
        args.remove("--dry-run")

    logger = setup_logger("kemr_torch.cli.parity")
    bpe_path = os.environ.get("CLIP_BPE_PATH")
    pt_path = os.environ.get("CLIP_PT_PATH")
    hf_path = os.environ.get("CLIP_HF_PATH")

    tmp_ctx = None
    if dry_run:
        # synthesize every artifact so the runbook machinery itself runs: a
        # tiny seeded OpenAI-layout checkpoint stands in for the .pt, and a
        # registered tiny arch keeps the eval stage fast
        from ..models import clip as M

        tmp_ctx = tempfile.TemporaryDirectory(prefix="kemr_parity_dry_")
        pt_path = _make_fake_pt(tmp_ctx.name)
        bpe_path, hf_path = None, None  # tokenizer/hf stages report skipped
        M.ARCHS.setdefault(
            "parity-dry", M.CLIPArch(16, 32, 1, 32, 16, 16, 600, 32, 2, 1, vision_heads=2)
        )
        if not any(a.startswith("--data.dataset") for a in args):
            args.append("--data.dataset=synthetic:32")
        args += ["--model.name=parity-dry", "--data.image_size=32",
                 "--data.context_length=16", "--eval.batch_size=8"]

    cfg = config_from_argv(args)

    results: Dict[str, Dict] = {}
    results["tokenizer"] = _stage(lambda: _stage_tokenizer(bpe_path))
    results["converter_openai"] = _stage(lambda: _stage_converter_pt(pt_path, device))
    results["converter_hf"] = _stage(lambda: _stage_converter_hf(hf_path, device))
    out_dir = os.path.dirname(os.path.abspath(out_path)) or "."
    # real runs evaluate the converted artifact; the dry run evaluates the
    # tiny seeded arch (the synthetic branch of _stage_evaluation)
    checkpoint = None if dry_run else (cfg.model.checkpoint or pt_path)
    results["evaluation"] = _stage(
        lambda: _stage_evaluation(cfg, checkpoint, bpe_path, out_dir, device)
    )

    statuses = {k: v["status"] for k, v in results.items()}
    ok = all(s != "failed" for s in statuses.values())
    ran = [k for k, s in statuses.items() if s == "ok"]
    report = {
        "ok": ok,
        "dry_run": dry_run,
        "stages": statuses,
        "ran": ran,
        "results": results,
        "artifacts": {
            "CLIP_BPE_PATH": bpe_path,
            "CLIP_PT_PATH": pt_path,
            "CLIP_HF_PATH": hf_path,
            "dataset": cfg.data.dataset,
        },
    }
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    for name, status in statuses.items():
        logger.info("parity stage %-17s %s", name, status)
    logger.info("wrote %s (ok=%s)", out_path, ok)
    if tmp_ctx is not None:
        tmp_ctx.cleanup()
    return report


def _make_fake_pt(tmp_dir: str) -> str:
    """A tiny seeded model in the OpenAI ``.pt`` layout (the dry run's
    stand-in for a real checkpoint: exercises load + convert + forward)."""
    from ..models import clip as M
    from ..models.convert import save_openai_pt

    # widths of 64 so arch_from_state_dict's head inference (width // 64,
    # the OpenAI convention: explicit head counts don't survive a
    # checkpoint) reconstructs a valid arch from the written shapes
    arch = M.CLIPArch(32, 32, 1, 64, 16, 16, 64, 64, 1, 1)
    path = os.path.join(tmp_dir, "fake_clip.pt")
    save_openai_pt(M.build_model("", dtype=torch.float32, seed=0, arch=arch), path)
    return path


if __name__ == "__main__":
    main()
