"""The tiny training world the multi-process test and its worker share (no JAX)."""

import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, make_synthetic_source
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as M
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]


def build():
    """A seeded f32 model of ``tests/test_trainer.py``'s TINY arch and a 32-row synthetic pipeline."""
    tok = CLIPTokenizer(MERGES)
    arch = M.CLIPArch(16, 32, 1, 32, 16, 16, tok.vocab_size, 32, 2, 1, vision_heads=2)
    model = M.build_model("tiny", dtype=torch.float32, seed=0, arch=arch)
    pipe = DataPipeline(make_synthetic_source(32, image_size=32), tok, image_size=32, context_length=16, num_workers=1)
    return model, pipe


def mp_config(checkpoint_dir: str) -> TrainConfig:
    return TrainConfig(batch_size=8, epochs=2, lr=1e-3, early_stop_patience=3, log_every=100,
                       global_negatives=True, checkpoint_dir=checkpoint_dir)


def adamw_format(opt) -> dict:
    """An ``Optimizer``'s state in the port's earlier checkpoint format:
    torch's own AdamW state dict (its parameters by index) under ``"adamw"``."""
    return {"adamw": opt.adamw.state_dict(), "count": opt.count, "mini_step": opt.mini_step,
            "acc": None if opt.acc is None else dict(zip(opt.trainable, opt.acc))}
