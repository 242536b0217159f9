"""Training: the core CLIP fine-tuning loop and the fusion-head stage."""

from .fusion_trainer import evaluate_fusion_model, load_fusion_head, save_fusion_head, train_fusion_head  # noqa: F401
from .losses import (  # noqa: F401
    info_nce,
    joint_contrastive_loss,
    joint_loss_for_config,
    joint_sigmoid_loss,
    sigmoid_contrastive,
)
from .schedule import cosine_annealing_lr  # noqa: F401
from .trainer import CLIPTrainer, EarlyStopper, make_optimizer, make_train_step  # noqa: F401
