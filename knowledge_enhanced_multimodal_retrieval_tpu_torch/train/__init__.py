"""Training (only the fusion-head stage is ported so far)."""

from .fusion_trainer import evaluate_fusion_model, load_fusion_head, save_fusion_head, train_fusion_head  # noqa: F401
