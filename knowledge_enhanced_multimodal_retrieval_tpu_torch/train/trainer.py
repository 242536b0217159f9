"""CLIP fine-tuning on one device.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/trainer.py``
on one card (the JAX package's data-parallel step on a one-device mesh):

- the joint T2I + T2T loss of ``train.losses`` over the whole batch; on one
  device global negatives equal local ones;
- the JAX optimizer chain (optax) on the CLIP module's parameters: clipping
  by the global norm in optax's form, AdamW (beta 0.9 / 0.98, eps 1e-6,
  weight decay on every parameter but ``logit_scale``) under a per-epoch
  cosine schedule, gradient accumulation as ``optax.MultiSteps`` (a running
  mean of the micro-step gradients), and encoder freezing as
  ``optax.multi_transform``: clipping and AdamW cover only the trainable
  parameters, frozen ones get gradients (they count in the reported
  ``grad_norm``) but no update and no decay;
- an EMA shadow updated on every step (micro-steps included), FLIP patch
  subsets drawn from a ``torch.Generator`` seeded by (seed, step), ``remat``;
- the training variants: QAT (``train.qat``) and LoRA (``train.lora``) at
  the block projections' hook, held over each step's forward and backward;
  GradCache (``train.gradcache``, ``grad_cache_chunks > 1``); mined hard
  negatives (``train.negatives``: each example's mined target texts join
  the loss denominators); distillation (``train.distill``, its own step);
- ``CLIPTrainer``: epoch loop, validation (T2I + T2T MRR), latest / best
  checkpoints (``train.checkpoint``), early stopping, a SIGTERM drain that
  saves a resumable checkpoint; a LoRA run's state is the adapters and their
  optimizer, the frozen base beside it.

Compute runs in the model's dtype (bf16 on the card) with f32 parameters, as
in the JAX package. Attention runs the B6/B7 kernel forward on a CUDA tensor
and recomputes its gradient through the plain version. The sharded steps of
ROADMAP A5 (b) raise ``NotImplementedError`` where the JAX trainer branches to
them; the JAX trainer's refusals of variant combinations raise ``ValueError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue as queue_mod
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..data.datasets import Batch, DataPipeline
from ..eval.metrics import average_mrr, compute_training_metrics
from ..models.clip import CLIP, l2_normalize
from ..utils.config import MeshConfig, TrainConfig
from ..utils.logging_utils import MetricsWriter, is_coordinator, setup_logger
from . import checkpoint as ckpt
from .losses import joint_loss_for_config, require_one_process
from .distill import TeacherBank, load_encoded_dataset, make_distill_step
from .gradcache import gradcache_value_and_grad
from .lora import lora_init, lora_merge, lora_param_count, lora_projections
from .negatives import load_negatives
from .qat import qat_hook, qat_projections
from .schedule import cosine_annealing_lr

# The reference validates on T2I + T2T only and early-stops on their mean MRR.
VAL_TASKS = ("T2I", "T2T")
A5 = "ROADMAP A5 (b) (parallel training)"

Params = Dict[str, torch.Tensor]


def sync_early_stop_monitor(value: float) -> float:
    """The coordinator's monitor value on every process: the identity on one."""
    require_one_process("the early-stop monitor broadcast")
    return float(value)


def sync_preempt_flag(flag: bool) -> bool:
    """The OR of the processes' preemption flags: the identity on one."""
    require_one_process("the preemption flag")
    return bool(flag)


class PreemptionGuard:
    """Cooperative SIGTERM drain: the handler sets a flag the train loop
    polls at step boundaries, so the trainer saves a resumable checkpoint and
    returns instead of dying mid-epoch. Installs only from the main thread;
    ``trigger()`` sets the flag directly (tests, a watchdog)."""

    def __init__(self, signals=(signal.SIGTERM,), install: bool = True):
        self._flag = False
        self._installed = []
        if install and threading.current_thread() is threading.main_thread():
            for s in signals:
                try:
                    prev = signal.signal(s, self._on_signal)
                except (ValueError, OSError):
                    continue
                self._installed.append((s, prev))

    def _on_signal(self, signum, frame):
        self._flag = True

    def trigger(self) -> None:
        self._flag = True

    @property
    def triggered(self) -> bool:
        return self._flag

    def uninstall(self) -> None:
        for s, prev in self._installed:
            signal.signal(s, prev)
        self._installed = []

    def __enter__(self) -> "PreemptionGuard":
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def trainable_labels(names: Iterable[str], freeze_image: bool, freeze_text: bool) -> Dict[str, str]:
    """'train' or 'frozen' per parameter name: freezing keeps the projections
    (and the final text LayerNorm) and ``logit_scale`` trainable."""

    def label(name: str) -> str:
        if name in ("logit_scale", "visual.proj", "text.text_projection") or name.startswith("text.ln_final."):
            return "train"
        if name.startswith("visual."):
            return "frozen" if freeze_image else "train"
        if name.startswith("text."):
            return "frozen" if freeze_text else "train"
        return "train"

    return {n: label(n) for n in names}


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (0-dim, f32)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


class Optimizer:
    """The JAX package's optimizer chain (``make_optimizer``) on named
    parameters. :meth:`step` takes one micro-step's gradients: with
    ``grad_accum_steps`` k > 1 it keeps their running mean (``acc + (g -
    acc) / (n + 1)``) and updates on every k-th call, the counter carrying
    across epochs; the update clips the (mean) gradient of the trainable
    parameters to ``grad_clip_norm`` by ``g * (max_norm / norm)`` where
    ``norm >= max_norm`` (optax's rule: no epsilon), then takes one AdamW
    step at ``schedule(count)``, ``count`` the 0-based optimizer step."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter], cfg: TrainConfig, steps_per_epoch: int):
        self.k = max(1, cfg.grad_accum_steps)
        labels = trainable_labels(named_params, cfg.freeze_image_encoder, cfg.freeze_text_encoder)
        self.trainable = [n for n in named_params if labels[n] == "train"]
        self.params = [named_params[n] for n in self.trainable]
        # logit_scale gets no gradient (the loss uses the fixed temperature);
        # it is kept out of the weight decay, as the JAX mask does
        decay = [p for n, p in zip(self.trainable, self.params) if n != "logit_scale"]
        no_decay = [p for n, p in zip(self.trainable, self.params) if n == "logit_scale"]
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay}, {"params": no_decay, "weight_decay": 0.0}],
            lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=cfg.eps,
        )
        # the cosine anneals per epoch in OPTIMIZER steps
        opt_steps_per_epoch = max(1, -(-steps_per_epoch // self.k))
        self.schedule = cosine_annealing_lr(cfg.lr, cfg.epochs, opt_steps_per_epoch, cfg.eta_min_factor,
                                            warmup_steps=cfg.warmup_steps)
        self.max_norm = float(cfg.grad_clip_norm)
        self.count = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params] if self.k > 1 else None

    def step(self, grads: Params) -> None:
        g = [grads[n] for n in self.trainable]
        if self.acc is not None:
            n = self.mini_step
            for a, gi in zip(self.acc, g):
                a.add_((gi - a) / (n + 1))
            if n < self.k - 1:
                self.mini_step += 1
                return
            self.mini_step = 0
            g = self.acc
        factor = torch.clamp(self.max_norm / global_norm(g), max=1.0)  # 1 below max_norm: g unchanged
        torch._foreach_mul_(g, factor)
        for p, gi in zip(self.params, g):
            p.grad = gi
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            torch._foreach_zero_(self.acc)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "adamw": self.adamw.state_dict(),
            "count": self.count,
            "mini_step": self.mini_step,
            "acc": None if self.acc is None else dict(zip(self.trainable, self.acc)),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self.acc is not None:
            for a, n in zip(self.acc, self.trainable):
                a.copy_(sd["acc"][n])


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int, model: CLIP) -> Optimizer:
    return Optimizer(dict(model.named_parameters()), cfg, steps_per_epoch)


def collect_grads(params: Params) -> Params:
    """Each parameter's ``.grad`` (zeros where it got none), then cleared."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return grads


def apply_gradients(state: "TrainState", grads: Params, metrics: Dict[str, torch.Tensor]):
    """``grad_norm`` (over every gradient, frozen ones included) into
    ``metrics``, the optimizer on this micro-step's gradients, the step count."""
    metrics["grad_norm"] = global_norm(list(grads.values()))
    state.optimizer.step(grads)
    state.step += 1
    return state, metrics


def _ema_update(ema: Params, params: Params, decay: float) -> None:
    """``ema = decay * ema + (1 - decay) * params``, in place."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n].detach() for n in names], alpha=1.0 - decay)


def device_prefetch(batches: Iterable, place_fn: Callable, depth: int = 1) -> Iterator:
    """Iterate ``place_fn(batch)`` one step ahead on a background thread, so
    host preprocessing of the next batch overlaps this step's device work.
    Exceptions of the worker (the data source included) re-raise here."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, depth))
    sentinel = object()
    errors = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded-timeout put: an abandoned consumer cannot strand the thread
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if stop.is_set() or not _put(place_fn(b)):
                    return
        except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
            errors.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True, name="kemr-prefetch").start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()  # unblock the worker on early exit
        while True:
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def projections_for_config(model: CLIP, cfg: TrainConfig, adapters: Optional[Params] = None,
                           lora_scale: float = 1.0) -> contextlib.AbstractContextManager:
    """What a train step holds over its forward and backward: LoRA's merge
    (given ``adapters``) and / or QAT's fake quantization (``cfg.qat``, on
    the merged weights) at the block projections; nothing for neither."""
    if adapters is not None:
        return lora_projections(model, adapters, lora_scale, then=qat_hook if cfg.qat else None)
    return qat_projections(model) if cfg.qat else contextlib.nullcontext()


def forward_for_config(model: CLIP, cfg: TrainConfig) -> Callable:
    """One train-step forward ``fwd(method, *args)``: the module's own, or
    QAT's fake-quantized one (``cfg.qat``)."""

    def fwd(method: str, *args):
        with projections_for_config(model, cfg):
            return getattr(model, method)(*args)

    return fwd


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The FLIP draw of one step: a generator on ``device`` seeded by
    (seed, step), so a resumed run draws the same subsets."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def sample_keep_idx(generator: torch.Generator, batch: int, n_patches: int, ratio: float) -> torch.Tensor:
    """FLIP patch subsets: ``[B, max(1, round(P * (1 - ratio)))]`` distinct
    patch indices per image (uniform noise, top-k: a static count)."""
    keep = max(1, int(round(n_patches * (1.0 - ratio))))
    noise = torch.rand(batch, n_patches, generator=generator, device=generator.device)
    return noise.topk(keep, dim=-1).indices


@dataclasses.dataclass
class TrainState:
    """What a step updates: the module's parameters (in place) or, in a LoRA
    run, the ``adapters`` (the module is the frozen base), the optimizer, the
    step count (micro-steps included) and the EMA shadow. A checkpoint's
    ``params`` are what the step trains."""

    model: CLIP
    optimizer: Optimizer
    step: int = 0
    ema_params: Optional[Params] = None
    adapters: Optional[Params] = None

    def state_dict(self) -> Dict[str, Any]:
        params = dict(self.model.state_dict()) if self.adapters is None else self.adapters
        out = {"params": params, "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            out["ema_params"] = self.ema_params
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if self.adapters is None:
            self.model.load_state_dict(sd["params"])
        else:
            with torch.no_grad():
                for n, a in self.adapters.items():
                    a.copy_(sd["params"][n])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        if self.ema_params is not None:
            for n, e in self.ema_params.items():
                e.copy_(sd["ema_params"][n])


def make_train_step(model: CLIP, cfg: TrainConfig, adapters: Optional[Params] = None,
                    lora_scale: float = 1.0) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: forward both towers
    (the text tower once for queries, once for targets, and once for the
    flattened ``batch["neg_ids"]`` ``[B, k, L]`` with mined negatives), the
    joint loss, backward (GradCache's three passes with ``grad_cache_chunks
    > 1``), the optimizer on this micro-step's gradients, then the EMA.
    Given ``adapters`` the step trains them on the frozen module (LoRA).
    ``metrics`` are 0-dim device tensors (no host sync): the loss's keys
    and ``grad_norm``, the global norm of every trained tensor's gradient."""
    joint_loss = joint_loss_for_config(cfg)
    loss_axis = "data" if cfg.global_negatives else None  # one process: gathers nothing
    n_patches = model.arch.grid_size**2
    n_gc = int(cfg.grad_cache_chunks)
    use_negs = bool(cfg.hard_negatives) and cfg.hard_negatives_k > 0
    params = dict(model.named_parameters()) if adapters is None else adapters

    def enc_img(*args):
        return l2_normalize(model.encode_image(*args))

    def enc_txt(ids):
        return l2_normalize(model.encode_text(ids))

    def emb_loss(img_e, q_e, t_e, neg_e=None):
        kw = {} if neg_e is None else {"neg_text_features": neg_e}
        return joint_loss(img_e, q_e, t_e, temperature=cfg.temperature, t2i_weight=cfg.t2i_weight,
                          t2t_weight=cfg.t2t_weight, axis_name=loss_axis, **kw)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        images = batch["images"]
        img_args = (images,)
        if cfg.image_mask_ratio > 0:
            gen = step_generator(cfg.seed, state.step, images.device)
            img_args = (images, sample_keep_idx(gen, images.shape[0], n_patches, cfg.image_mask_ratio))
        towers = [(enc_img, img_args), (enc_txt, (batch["query_ids"],)), (enc_txt, (batch["target_ids"],))]
        if use_negs:
            towers.append((enc_txt, (batch["neg_ids"].reshape(-1, batch["neg_ids"].shape[-1]),)))
        with projections_for_config(model, cfg, adapters, lora_scale):
            if n_gc > 1:
                (_, metrics), grads = gradcache_value_and_grad(emb_loss, towers, params, n_gc)
            else:
                for p in params.values():
                    p.grad = None
                loss, metrics = emb_loss(*(enc(*ins) for enc, ins in towers))
                loss.backward()
                grads = collect_grads(params)
        state, metrics = apply_gradients(state, grads, {k: v.detach() for k, v in metrics.items()})
        if state.ema_params is not None:
            _ema_update(state.ema_params, params, cfg.ema_decay)
        return state, metrics

    return train_step


def encode_batch(model: CLIP, params: Optional[Params], images, query_ids, target_ids):
    """L2-normalized (image, query, target) embeddings of one batch, with the
    module's own weights or, given ``params`` (names as the module's), those."""
    def tower(name: str):
        module = getattr(model, name)
        if params is None:
            return module
        prefix = name + "."
        sub = {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}
        return lambda *args: torch.func.functional_call(module, sub, args)

    visual, text = tower("visual"), tower("text")
    return l2_normalize(visual(images)), l2_normalize(text(query_ids)), l2_normalize(text(target_ids))


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EarlyStopper:
    """Patience-based early stopping on a max-metric."""

    patience: int
    best: float = -float("inf")
    best_epoch: int = -1
    bad_epochs: int = 0

    def update(self, value: float, epoch: int) -> bool:
        """Record an epoch's metric; True if it is a new best."""
        if value > self.best:
            self.best = value
            self.best_epoch = epoch
            self.bad_epochs = 0
            return True
        self.bad_epochs += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.bad_epochs >= self.patience


class CLIPTrainer:
    """Epoch-loop orchestration on the device that holds ``model``'s
    parameters, which it trains in place."""

    def __init__(
        self,
        model: CLIP,
        train_data: DataPipeline,
        val_data: Optional[DataPipeline],
        cfg: TrainConfig,
        mesh: Optional[MeshConfig] = None,
        out_dir: str = "experiments/train",
    ):
        self.model = model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.train_data = train_data
        self.val_data = val_data
        self.out_dir = out_dir
        self.logger = setup_logger("kemr_torch.train")
        self.metrics_writer = MetricsWriter(out_dir, "train")
        self._wandb = None
        if cfg.wandb_project and is_coordinator():
            try:  # optional dependency
                import wandb

                self._wandb = wandb.init(project=cfg.wandb_project, config=dataclasses.asdict(cfg))
            except Exception as e:  # noqa: BLE001 -- logging is optional
                self.logger.warning("wandb unavailable: %s", e)
        self.steps_per_epoch = train_data.num_batches(cfg.batch_size)
        self.lora = cfg.lora_rank > 0
        self.distill_bank = None
        self.neg_table = self.neg_uuids = None
        if cfg.hard_negatives and cfg.hard_negatives_k > 0:
            # each batch example's top-k mined examples' target texts join the loss denominators
            if cfg.distill_teacher:
                raise ValueError("hard_negatives does not apply to the distill step")
            self.neg_table, self.neg_uuids = load_negatives(cfg.hard_negatives)
            if self.neg_table.shape[0] != len(train_data):
                raise ValueError(
                    f"hard-negative table has {self.neg_table.shape[0]} rows but the training split has "
                    f"{len(train_data)} examples — re-mine (cli.mine_negatives) on this split"
                )
            if self.neg_table.shape[1] < cfg.hard_negatives_k:
                raise ValueError(
                    f"hard_negatives_k={cfg.hard_negatives_k} exceeds the mined table width {self.neg_table.shape[1]}"
                )
            self.logger.info("hard negatives: %s ([%d, %d] table, using k=%d)", cfg.hard_negatives,
                             *self.neg_table.shape, cfg.hard_negatives_k)
        self.ema = cfg.ema_decay > 0.0
        if self.ema and not (0.0 < cfg.ema_decay < 1.0):
            raise ValueError(f"ema_decay must be in (0, 1), got {cfg.ema_decay}")
        if self.ema and (self.lora or cfg.distill_teacher):
            raise ValueError("ema_decay rides the DP/GSPMD full-fine-tune steps only")
        mesh = mesh or MeshConfig()
        if mesh.model_parallel > 1 or mesh.fsdp:
            raise NotImplementedError(f"tensor-parallel and FSDP training are not ported yet: {A5}")
        if self.lora:
            if cfg.distill_teacher:
                raise ValueError("distill_teacher and lora_rank are mutually exclusive")
            # the frozen base stays in the module; the state trains rank-r adapters
            base = dict(model.named_parameters())
            for p in base.values():
                p.requires_grad_(False)
            adapters = lora_init(base, cfg.lora_rank, cfg.lora_targets, torch.Generator().manual_seed(cfg.seed))
            adapters = {n: torch.nn.Parameter(a) for n, a in adapters.items()}
            self.lora_scale = cfg.lora_alpha / cfg.lora_rank
            optimizer = Optimizer(adapters, cfg, self.steps_per_epoch)
            self.state = TrainState(model, optimizer, 0, None, adapters)
            self.train_step = make_train_step(model, cfg, adapters, self.lora_scale)
            self.logger.info("LoRA rank %d (%s): %d trainable adapter params", cfg.lora_rank, cfg.lora_targets,
                             lora_param_count(adapters))
        elif cfg.distill_teacher:
            # teacher embeddings precomputed offline ride the batch; the step swaps InfoNCE for the KD loss
            self.distill_bank = TeacherBank(load_encoded_dataset(cfg.distill_teacher))
            self.state = TrainState(model, make_optimizer(cfg, self.steps_per_epoch, model))
            self.train_step = make_distill_step(model, cfg, model.arch.embed_dim, self.distill_bank.dim)
            self.logger.info("distilling from %s (%d teacher rows, dim %d -> student dim %d)", cfg.distill_teacher,
                             len(self.distill_bank.enc.uuids), self.distill_bank.dim, model.arch.embed_dim)
        else:
            optimizer = make_optimizer(cfg, self.steps_per_epoch, model)
            ema = {n: p.detach().clone() for n, p in model.named_parameters()} if self.ema else None
            self.state = TrainState(model, optimizer, 0, ema)
            self.train_step = make_train_step(model, cfg)
        self.stopper = EarlyStopper(cfg.early_stop_patience)
        self.start_epoch = 0
        if cfg.resume and ckpt.checkpoint_exists(cfg.checkpoint_dir, "latest"):
            self._resume()

    # -- checkpointing ------------------------------------------------------

    def _resume(self) -> None:
        state, meta = ckpt.load_checkpoint(self.cfg.checkpoint_dir, "latest")
        self.state.load_state_dict(state)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.stopper.best = float(meta.get("best_metric", -float("inf")))
        self.stopper.best_epoch = int(meta.get("best_epoch", -1))
        self.logger.info("resumed from epoch %d (best %.4f @ %d)", self.start_epoch, self.stopper.best,
                         self.stopper.best_epoch)

    def _save(self, role: str, epoch: int) -> None:
        ckpt.save_checkpoint(
            self.cfg.checkpoint_dir, role, self.state.state_dict(),
            {"epoch": epoch, "best_metric": self.stopper.best, "best_epoch": self.stopper.best_epoch},
        )

    # -- data placement -----------------------------------------------------

    def _device_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        host = {"images": batch.images, "query_ids": batch.query_ids, "target_ids": batch.target_ids}
        if self.distill_bank is not None:
            host["t_img"], host["t_q"], host["t_t"] = self.distill_bank.rows(batch.uuids)
        if self.neg_table is not None:
            # the mined table must describe this dataset's rows
            for row, uuid in zip(np.asarray(batch.indices), batch.uuids):
                if self.neg_uuids[int(row)] != uuid:
                    raise ValueError(
                        f"hard-negative table row {row} is '{self.neg_uuids[int(row)]}' but the batch example is "
                        f"'{uuid}' — the table was mined on a different/reordered dataset"
                    )
            host["neg_ids"] = self.train_data.negative_target_ids(batch.indices, self.neg_table,
                                                                  self.cfg.hard_negatives_k)
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in host.items()}

    # -- validation ---------------------------------------------------------

    def eval_params(self) -> Params:
        """The weights to evaluate and export: in a LoRA run the base merged
        with the current adapters (``W + s (a @ b)ᵀ``), the EMA shadow when
        ``ema_decay`` is set, else the trained parameters."""
        if self.lora:
            with torch.no_grad():
                return lora_merge(dict(self.model.named_parameters()), self.state.adapters, self.lora_scale)
        if self.state.ema_params is not None:
            return self.state.ema_params
        return dict(self.model.named_parameters())

    def validate(self) -> Dict[str, float]:
        """MRR-only validation over the whole validation split (T2I, T2T)."""
        if self.val_data is None:
            return {}
        # merged once a pass; None: the module's own weights
        params = self.eval_params() if (self.lora or self.state.ema_params is not None) else None
        embs = {"img": [], "q": [], "t": []}
        with torch.no_grad():
            for batch in self.val_data.epoch_batches(self.cfg.batch_size, shuffle=False, drop_last=False):
                db = self._device_batch(batch)
                img, q, t = encode_batch(self.model, params, db["images"], db["query_ids"], db["target_ids"])
                embs["img"].append(img)
                embs["q"].append(q)
                embs["t"].append(t)
        if not embs["img"]:
            return {}
        img, q, t = (torch.cat(embs[k]) for k in ("img", "q", "t"))
        return compute_training_metrics(q, t, img, tasks=VAL_TASKS)

    # -- main loop ----------------------------------------------------------

    def train(self, guard: Optional[PreemptionGuard] = None) -> Dict[str, Any]:
        # an injected guard lets tests and watchdogs drive the drain
        guard = guard or PreemptionGuard(install=self.cfg.preempt_save)
        try:
            return self._train(guard)
        finally:
            guard.uninstall()

    def _train(self, guard: PreemptionGuard) -> Dict[str, Any]:
        cfg = self.cfg
        history = []
        preempted = False
        for epoch in range(self.start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            # per-epoch metric means, summed on the device: no host sync a step
            metric_sums = None
            n_steps = 0
            batches = self.train_data.epoch_batches(cfg.batch_size, epoch=epoch, shuffle=True, seed=cfg.seed,
                                                    drop_last=True)
            for db in device_prefetch(batches, self._device_batch):
                self.state, metrics = self.train_step(self.state, db)
                metric_sums = metrics if metric_sums is None else {k: metric_sums[k] + v for k, v in metrics.items()}
                n_steps += 1
                if n_steps % cfg.log_every == 0:
                    self.logger.info("epoch %d step %d/%d: loss=%.4f", epoch, n_steps, self.steps_per_epoch,
                                     float(metrics["loss"]))
                if (
                    cfg.preempt_save
                    and cfg.preempt_check_every
                    and n_steps % cfg.preempt_check_every == 0
                    and sync_preempt_flag(guard.triggered)
                ):
                    preempted = True
                    break
            if not preempted and cfg.preempt_save and sync_preempt_flag(guard.triggered):
                preempted = True  # the signal landed in the epoch's tail steps
            if preempted:
                # salvage save recorded at epoch - 1: resuming restarts this
                # epoch's data pass from the mid-epoch weights
                self._save("latest", epoch - 1)
                ckpt.wait_for_checkpoints()
                self.logger.info("preempted at epoch %d step %d: salvage checkpoint saved, draining", epoch, n_steps)
                history.append({
                    "epoch": epoch, "steps": n_steps, "preempted": True,
                    "train": {k: float(v) / n_steps for k, v in metric_sums.items()} if metric_sums else {},
                })
                break
            running = {k: float(v) / n_steps for k, v in metric_sums.items()} if metric_sums else {}
            epoch_time = time.perf_counter() - t0

            val_metrics = self.validate()
            monitor = {
                "avg_mrr": average_mrr(val_metrics, tasks=VAL_TASKS),
                "t2i_mrr": val_metrics.get("T2I_MRR", 0.0),
                "t2t_mrr": val_metrics.get("T2T_MRR", 0.0),
            }.get(cfg.early_stop_metric, 0.0)
            monitor = sync_early_stop_monitor(monitor)

            record = {
                "epoch": epoch,
                "train": running,
                "val": val_metrics,
                "monitor": monitor,
                "epoch_time_s": epoch_time,
                "steps": n_steps,
            }
            history.append(record)
            self.metrics_writer.log(epoch, record)
            if self._wandb is not None:
                self._wandb.log({"epoch": epoch, **{f"train/{k}": v for k, v in running.items()},
                                 **{f"val/{k}": v for k, v in val_metrics.items()}})
            self.logger.info("epoch %d: loss=%.4f monitor(%s)=%.4f (%.1fs)", epoch, running.get("loss", float("nan")),
                             cfg.early_stop_metric, monitor, epoch_time)

            improved = self.stopper.update(monitor, epoch)
            self._save("latest", epoch)
            if improved:
                self._save("best", epoch)
            if self.stopper.should_stop:
                self.logger.info("early stop at epoch %d (best %.4f @ %d)", epoch, self.stopper.best,
                                 self.stopper.best_epoch)
                break

        final = {
            "best_metric": self.stopper.best,
            "best_epoch": self.stopper.best_epoch,
            "epochs_run": len(history),
            "preempted": preempted,
            "history": history,
        }
        ckpt.wait_for_checkpoints()  # flush the asynchronous epoch saves
        self.metrics_writer.finalize(final)
        return final
