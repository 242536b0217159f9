"""Training: the core CLIP fine-tuning loop, its variants (LoRA, QAT,
GradCache, mined negatives, distillation) and the fusion-head stage."""

from .distill import TeacherBank, distill_loss, load_encoded_dataset, make_distill_step, save_encoded_dataset  # noqa: F401
from .fusion_trainer import evaluate_fusion_model, load_fusion_head, save_fusion_head, train_fusion_head  # noqa: F401
from .gradcache import gradcache_value_and_grad  # noqa: F401
from .lora import load_adapters, lora_init, lora_merge, lora_merge_host, lora_param_count, save_adapters  # noqa: F401
from .losses import (  # noqa: F401
    info_nce,
    joint_contrastive_loss,
    joint_loss_for_config,
    joint_sigmoid_loss,
    sigmoid_contrastive,
)
from .negatives import load_negatives, mine_hard_negatives, save_negatives, uuid_digest  # noqa: F401
from .qat import fake_quant_rows, fake_quant_weight, qat_params  # noqa: F401
from .schedule import cosine_annealing_lr  # noqa: F401
from .trainer import CLIPTrainer, EarlyStopper, make_optimizer, make_train_step  # noqa: F401
