"""CLIP fine-tuning on one device or over a device mesh.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/trainer.py``:

- the joint T2I + T2T loss of ``train.losses``;
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
- over a mesh (``parallel.mesh.MeshRuntime``): the data-parallel step (JAX
  ``make_train_step``'s ``shard_map``): the batch cut into ``rt.num_data``
  row shards over ``('dcn', 'data')``, each shard's towers on its device
  (``parallel.replicas``), the loss per shard (local negatives, or the
  gathered columns of every shard with ``global_negatives``), gradients and
  metrics averaged over the shards (``pmean``), across processes through
  ``torch.distributed``; and the GSPMD step (``make_train_step_gspmd``) over
  FSDP and / or tensor-parallel blocks (``parallel.fsdp``, ``parallel.tp``),
  which always scores the global batch; the sharded encode steps;
- ``CLIPTrainer``: epoch loop, validation (T2I + T2T MRR), latest / best
  checkpoints (``train.checkpoint``: whole tensors, written by the
  coordinator), early stopping agreed across processes, a SIGTERM drain
  that saves a resumable checkpoint; a LoRA run's state is the adapters and
  their optimizer, the frozen base beside it.

Compute runs in the model's dtype (bf16 on the card) with f32 parameters, as
in the JAX package. Attention runs the B6/B7 kernel forward on a CUDA tensor
and recomputes its gradient through the plain version. The JAX trainer's
refusals of variant combinations raise ``ValueError``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
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
from ..parallel.fsdp import BlockGather
from ..parallel.mesh import MeshRuntime
from ..parallel.replicas import MeshReplicas, moved
from ..parallel.sharding import RowShards, ShardedParams, all_gather_processes, all_reduce_, host_local_batch_to_global
from ..utils.config import MeshConfig, TrainConfig
from ..utils.logging_utils import MetricsWriter, is_coordinator, setup_logger
from ..utils.profiling import span, spanned
from . import checkpoint as ckpt
from .losses import joint_loss_for_config, process_group
from .distill import TeacherBank, load_encoded_dataset, make_distill_step
from .gradcache import gradcache_value_and_grad
from .lora import lora_init, lora_merge, lora_param_count, lora_projections
from .negatives import load_negatives
from .qat import qat_hook, qat_projections
from .schedule import cosine_annealing_lr

# The reference validates on T2I + T2T only and early-stops on their mean MRR.
VAL_TASKS = ("T2I", "T2T")

Params = Dict[str, torch.Tensor]


def _agree(value: float, op: str) -> float:
    """``value`` reduced over the processes (``"max"``), or rank 0's (``"first"``)."""
    group = process_group()
    if group is None:
        return value
    t = torch.tensor([value if op == "max" or torch.distributed.get_rank(group) == 0 else 0.0], dtype=torch.float64)
    all_reduce_([t], group, "max" if op == "max" else "sum")
    return float(t[0])


def sync_early_stop_monitor(value: float) -> float:
    """The coordinator's monitor value on every process, so that every
    process takes the same stop decision (and runs the same collectives);
    the identity on one process."""
    return float(_agree(float(value), "first"))


def sync_preempt_flag(flag: bool) -> bool:
    """The OR of the processes' preemption flags, taken at the same step
    boundaries on every process, so all drain at the same step; the
    identity on one process."""
    return bool(_agree(1.0 if flag else 0.0, "max"))


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


def global_norm(tensors: List[torch.Tensor], layout: Optional[ShardedParams] = None,
                names: Optional[List[str]] = None) -> torch.Tensor:
    """sqrt of the sum of squares over every element (0-dim, f32), on the
    first tensor's device. Given a ``layout`` and the tensors' leaf
    ``names``, blocks that differ between processes count over all of them
    (an all-reduce) and blocks every process holds count once."""
    home = tensors[0].device
    sq = {}
    for t in tensors:
        sq.setdefault(t.device, []).append(t)
    per_dev = [torch.stack(torch._foreach_norm(ts)).float().square().sum().to(home) for ts in sq.values()]
    if layout is None or layout.mesh.process_count == 1:
        return torch.stack(per_dev).sum().sqrt()
    spans = [layout.spans_processes(ShardedParams.base_name(n)) for n in names]
    split = torch.zeros(2, dtype=torch.float32, device=home)
    for t, s in zip(tensors, spans):
        split[int(s)] += t.detach().float().square().sum().to(home)
    all_reduce_([split[1:]], layout.mesh.group, dtype=torch.float64)
    return split.sum().sqrt()


def _by_device(tensors: List[torch.Tensor]) -> Dict[torch.device, List[torch.Tensor]]:
    out: Dict[torch.device, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.device, []).append(t)
    return out


class Optimizer:
    """The JAX package's optimizer chain (``make_optimizer``) on named
    parameters. :meth:`step` takes one micro-step's gradients: with
    ``grad_accum_steps`` k > 1 it keeps their running mean (``acc + (g -
    acc) / (n + 1)``) and updates on every k-th call, the counter carrying
    across epochs; the update clips the (mean) gradient of the trainable
    parameters to ``grad_clip_norm`` by ``g * (max_norm / norm)`` where
    ``norm >= max_norm`` (optax's rule: no epsilon), then takes one AdamW
    step at ``schedule(count)``, ``count`` the 0-based optimizer step.

    Given a ``layout`` (``parallel.sharding.ShardedParams``) the named
    parameters are its blocks: AdamW's moments live beside each block (the
    moments shard like their parameters), the clip's norm is the whole
    gradient's, and :meth:`state_dict` holds whole tensors by parameter
    name whatever the layout, so a checkpoint resumes in any mode."""

    def __init__(self, named_params: Dict[str, torch.nn.Parameter], cfg: TrainConfig, steps_per_epoch: int,
                 layout: Optional[ShardedParams] = None):
        self.k = max(1, cfg.grad_accum_steps)
        self.layout = layout
        base = ShardedParams.base_name
        labels = trainable_labels({base(n) for n in named_params}, cfg.freeze_image_encoder, cfg.freeze_text_encoder)
        self.trainable = [n for n in named_params if labels[base(n)] == "train"]
        self.params = [named_params[n] for n in self.trainable]
        # logit_scale gets no gradient (the loss uses the fixed temperature);
        # it is kept out of the weight decay, as the JAX mask does
        decay = [p for n, p in zip(self.trainable, self.params) if base(n) != "logit_scale"]
        no_decay = [p for n, p in zip(self.trainable, self.params) if base(n) == "logit_scale"]
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

    def norm(self, tensors: List[torch.Tensor], names: List[str]) -> torch.Tensor:
        return global_norm(tensors, self.layout, names)

    @spanned("train.optimizer")
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
        factor = torch.clamp(self.max_norm / self.norm(g, self.trainable), max=1.0)  # 1 below max_norm: g unchanged
        for dev, ts in _by_device(g).items():
            torch._foreach_mul_(ts, factor.to(dev))
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

    def moment_tensors(self) -> Dict[str, List[torch.Tensor]]:
        """The AdamW state tensors beside each parameter (leaf) name."""
        return {n: [v for k, v in self.adamw.state[p].items() if k != "step"]
                for n, p in zip(self.trainable, self.params) if p in self.adamw.state}

    def _whole(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(leaves) if self.layout is None else self.layout.whole(leaves)

    def _split(self, whole: Dict[str, torch.Tensor], like: Dict[str, torch.Tensor]) -> None:
        if self.layout is not None:
            self.layout.load_whole(whole, like)
            return
        with torch.no_grad():
            for n, t in like.items():
                t.copy_(whole[n])

    def state_dict(self) -> Dict[str, Any]:
        named = dict(zip(self.trainable, self.params))
        st = {n: self.adamw.state[p] for n, p in named.items() if p in self.adamw.state}
        moments = {key: self._whole({n: s[key] for n, s in st.items()}) for key in ("exp_avg", "exp_avg_sq")}
        steps = {ShardedParams.base_name(n): float(s["step"]) for n, s in st.items()}
        return {
            "count": self.count,
            "mini_step": self.mini_step,
            "step": steps,
            **moments,
            "acc": None if self.acc is None else self._whole(dict(zip(self.trainable, self.acc))),
        }

    def _by_name(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """:meth:`state_dict`'s format from the earlier one, which held
        ``torch.optim.AdamW``'s own state under ``"adamw"`` (its parameters
        by index: the decayed ones in parameter order, then
        ``logit_scale``)."""
        if "step" in sd:
            return sd
        if "adamw" not in sd:
            raise ValueError(f"unknown optimizer state format (keys {sorted(sd)}): "
                             "expected 'step', 'exp_avg' and 'exp_avg_sq', or 'adamw'")
        names = list(dict.fromkeys(ShardedParams.base_name(n) for n in self.trainable))
        order = [n for n in names if n != "logit_scale"] + [n for n in names if n == "logit_scale"]
        indices = [i for g in sd["adamw"]["param_groups"] for i in g["params"]]
        if len(indices) != len(order):
            raise ValueError(f"optimizer state holds {len(indices)} parameters, this optimizer trains {len(order)}")
        st = {order[k]: sd["adamw"]["state"][i] for k, i in enumerate(indices) if i in sd["adamw"]["state"]}
        return dict(sd, step={n: float(s["step"]) for n, s in st.items()},
                    **{key: {n: s[key] for n, s in st.items()} for key in ("exp_avg", "exp_avg_sq")})

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        sd = self._by_name(sd)
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        base = ShardedParams.base_name
        named = {n: p for n, p in zip(self.trainable, self.params) if base(n) in sd["step"]}
        moments = {key: {n: torch.zeros_like(p) for n, p in named.items()} for key in ("exp_avg", "exp_avg_sq")}
        for key, like in moments.items():
            self._split(sd[key], like)
        for n, p in named.items():
            self.adamw.state[p] = {"step": torch.tensor(sd["step"][base(n)]), "exp_avg": moments["exp_avg"][n],
                                   "exp_avg_sq": moments["exp_avg_sq"][n]}
        if self.acc is not None:
            self._split(sd["acc"], dict(zip(self.trainable, self.acc)))


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
    with span("train.grad_norm"):
        metrics["grad_norm"] = state.optimizer.norm(list(grads.values()), list(grads))
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
                if stop.is_set():
                    return
                with span("train.feed.place"):
                    item = place_fn(b)
                if not _put(item):
                    return
        except Exception as e:  # noqa: BLE001 -- re-raised by the consumer
            errors.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True, name="kemr-prefetch").start()
    try:
        while True:
            with span("train.feed.wait"):
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


def step_generator(seed: int, step: int, device, shard: int = 0) -> torch.Generator:
    """The FLIP draw of one step (and data shard): a generator on ``device``
    seeded by (seed, step, shard), so a resumed run draws the same subsets
    and the shards draw apart (JAX folds the axis index in)."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step + shard * 1_000_000_007)


def sample_keep_idx(generator: torch.Generator, batch: int, n_patches: int, ratio: float) -> torch.Tensor:
    """FLIP patch subsets: ``[B, max(1, round(P * (1 - ratio)))]`` distinct
    patch indices per image (uniform noise, top-k: a static count)."""
    keep = max(1, int(round(n_patches * (1.0 - ratio))))
    noise = torch.rand(batch, n_patches, generator=generator, device=generator.device)
    return noise.topk(keep, dim=-1).indices


@dataclasses.dataclass
class TrainState:
    """What a step updates: the module's parameters (in place) or, in a LoRA
    run, the ``adapters`` (the module is the frozen base), or in a GSPMD run
    the ``layout``'s blocks (``parallel.sharding.ShardedParams``); the
    optimizer, the step count (micro-steps included) and the EMA shadow
    (keyed like what the step trains). A checkpoint holds whole tensors by
    parameter name in every mode (every process takes part in gathering
    them); its ``params`` are what the step trains."""

    model: CLIP
    optimizer: Optimizer
    step: int = 0
    ema_params: Optional[Params] = None
    adapters: Optional[Params] = None
    layout: Optional[ShardedParams] = None

    def params(self) -> Params:
        """The trained tensors by name (a layout's blocks by leaf name)."""
        if self.layout is not None:
            return self.layout.leaves()
        return self.adapters if self.adapters is not None else dict(self.model.named_parameters())

    def whole(self, tensors: Params) -> Params:
        """Tensors keyed like :meth:`params` as whole tensors by parameter name."""
        return self.layout.whole(tensors) if self.layout is not None else dict(tensors)

    def state_dict(self) -> Dict[str, Any]:
        if self.layout is not None:
            params = self.whole(self.layout.leaves())
        else:
            params = dict(self.model.state_dict()) if self.adapters is None else self.adapters
        out = {"params": params, "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            out["ema_params"] = self.whole(self.ema_params)
        return out

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if self.layout is not None:
            self.layout.load_whole(sd["params"], self.layout.leaves())
        elif self.adapters is None:
            self.model.load_state_dict(sd["params"])
        else:
            with torch.no_grad():
                for n, a in self.adapters.items():
                    a.copy_(sd["params"][n])
        self.optimizer.load_state_dict(sd["opt_state"])
        self.step = int(sd["step"])
        if self.ema_params is not None:
            if self.layout is not None:
                self.layout.load_whole(sd["ema_params"], self.ema_params)
            else:
                with torch.no_grad():
                    for n, e in self.ema_params.items():
                        e.copy_(sd["ema_params"][n])


def _tower_losses(cfg: TrainConfig, loss_axis):
    joint_loss = joint_loss_for_config(cfg)

    def emb_loss(img_e, q_e, t_e, neg_e=None):
        kw = {} if neg_e is None else {"neg_text_features": neg_e}
        return joint_loss(img_e, q_e, t_e, temperature=cfg.temperature, t2i_weight=cfg.t2i_weight,
                          t2t_weight=cfg.t2t_weight, axis_name=loss_axis, **kw)

    return emb_loss


def make_train_step(model: CLIP, cfg: TrainConfig, adapters: Optional[Params] = None,
                    lora_scale: float = 1.0, rt: Optional[MeshRuntime] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: forward both towers
    (the text tower once for queries, once for targets, and once for the
    flattened ``batch["neg_ids"]`` ``[B, k, L]`` with mined negatives), the
    joint loss, backward (GradCache's three passes with ``grad_cache_chunks
    > 1``), the optimizer on this micro-step's gradients, then the EMA.
    Given ``adapters`` the step trains them on the frozen module (LoRA).
    ``metrics`` are 0-dim device tensors (no host sync): the loss's keys
    and ``grad_norm``, the global norm of every trained tensor's gradient.

    Given a mesh runtime ``rt`` it is the data-parallel step (JAX
    ``make_train_step``): ``batch`` holds this process's rows (tensors, or
    the :class:`~..parallel.sharding.RowShards` of
    ``host_local_batch_to_global``), each data shard runs on its device,
    the loss is per shard (``global_negatives``: against every shard's
    columns) and gradients and metrics are the shards' mean."""
    if rt is not None:
        return _ShardedStep(model, cfg, rt, adapters=adapters, lora_scale=lora_scale)
    loss_axis = "data" if cfg.global_negatives else None  # one process: gathers nothing
    n_patches = model.arch.grid_size**2
    n_gc = int(cfg.grad_cache_chunks)
    use_negs = bool(cfg.hard_negatives) and cfg.hard_negatives_k > 0
    params = dict(model.named_parameters()) if adapters is None else adapters
    emb_loss = _tower_losses(cfg, loss_axis)

    def enc_img(*args):
        return l2_normalize(model.encode_image(*args))

    def enc_txt(ids):
        return l2_normalize(model.encode_text(ids))

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with span("train.step", id=state.step):
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
                    with span("train.forward"):
                        for p in params.values():
                            p.grad = None
                        loss, metrics = emb_loss(*(enc(*ins) for enc, ins in towers))
                    with span("train.backward"):
                        loss.backward()
                        grads = collect_grads(params)
            state, metrics = apply_gradients(state, grads, {k: v.detach() for k, v in metrics.items()})
            if state.ema_params is not None:
                with span("train.ema"):
                    _ema_update(state.ema_params, params, cfg.ema_decay)
            return state, metrics

    return train_step


def as_row_shards(batch: Dict[str, Any], rt: MeshRuntime) -> Dict[str, RowShards]:
    """A batch of this process's rows as its data shards (already cut: as it is)."""
    if all(isinstance(v, RowShards) for v in batch.values()):
        return batch
    return host_local_batch_to_global(batch, rt.mesh, rt.data_axes)


class _ShardTowers:
    """The towers of a mesh's data shards: each shard's module
    (``parallel.replicas``) bound, for a block, to tensors on its device
    row: the module's own parameters or whole tensors by name, moved to the
    row; or a ``layout``'s blocks, built a unit at a time near their use
    (``parallel.fsdp.BlockGather``: a residual block's when it runs and
    again when its backward recomputes it; the tensor-parallel projections
    left cut, ``parallel.tp``)."""

    def __init__(self, model: CLIP, rt: MeshRuntime, layout: Optional[ShardedParams] = None):
        self.model, self.rt, self.layout = model, rt, layout
        self.replicas = MeshReplicas(model, rt, own_params=layout is None)
        self.keep = rt.model_axis if layout is not None and rt.mesh.shape[rt.model_axis] > 1 else None
        self.gather: Optional[BlockGather] = None  # the layout's build while bound

    @contextlib.contextmanager
    def bound(self, params: Any = None, hooks: Optional[Callable] = None):
        """A context binding every shard's module: ``params`` None (the
        module's own parameters, or the layout's blocks), a view of the
        layout over other blocks (the EMA shadow), or whole tensors by name
        (every module, the caller's own too); ``hooks(module, row)`` (QAT,
        LoRA) held as well."""
        layout = params if isinstance(params, ShardedParams) else self.layout if params is None else None
        if layout is None:
            whole = params if params is not None else dict(self.model.named_parameters())
            with self.replicas.bound(lambda row: moved(whole, row[0]), hooks, rebind_own=params is not None):
                yield
            return
        self.gather = BlockGather(layout, self.keep)
        try:
            with self.gather.bound(self.replicas.modules, hooks):
                yield
        finally:
            self.gather = None

    def tower(self, method: str) -> Callable:
        """``enc(*args)``: each arg a list over this process's shards; the
        shards' L2-normalized embeddings stacked on the home device ``[S, B, D]``."""

        def enc(*args):
            with self.gather.saving() if self.gather is not None else contextlib.nullcontext():
                return self.replicas.per_shard(
                    lambda mod, j, row, g: l2_normalize(getattr(mod, method)(*(a[j] for a in args))))

        return enc


class _ShardedStep:
    """The train step over a mesh's data shards: the data-parallel step
    (replicated parameters: the module's own, or LoRA ``adapters``) or, given
    a ``layout``, the GSPMD step over its blocks (global-batch loss, the
    FLIP draw over the global batch). Also the distillation step (``loss``:
    a callable of the batch's per-shard tensors)."""

    def __init__(self, model: CLIP, cfg: TrainConfig, rt: MeshRuntime, adapters: Optional[Params] = None,
                 lora_scale: float = 1.0, layout: Optional[ShardedParams] = None, distill=None):
        self.model, self.cfg, self.rt = model, cfg, rt
        self.adapters, self.lora_scale, self.layout, self.distill = adapters, lora_scale, layout, distill
        self.towers = _ShardTowers(model, rt, layout)
        self.replicas = self.towers.replicas
        self.gspmd = layout is not None
        axes = rt.data_axes
        self.emb_loss = _tower_losses(cfg, axes if (cfg.global_negatives or self.gspmd) else None)
        self.params = (layout.leaves() if layout is not None
                       else adapters if adapters is not None else dict(model.named_parameters()))

    def hooks(self, mod, row):
        adapters = None if self.adapters is None else moved(self.adapters, row[0])
        return projections_for_config(mod, self.cfg, adapters, self.lora_scale)

    def keep_idx(self, step: int, images: List[torch.Tensor]) -> List[torch.Tensor]:
        cfg, n_patches = self.cfg, self.model.arch.grid_size**2
        if not self.gspmd:  # a fresh subset per shard
            return [sample_keep_idx(step_generator(cfg.seed, step, x.device, g), x.shape[0], n_patches,
                                    cfg.image_mask_ratio) for (g, _), x in zip(self.replicas.shards, images)]
        # one draw over the global batch, each shard its rows of it
        b = images[0].shape[0]
        home = self.replicas.home
        full = sample_keep_idx(step_generator(cfg.seed, step, home), b * self.rt.num_data, n_patches,
                               cfg.image_mask_ratio)
        return [full[g * b:(g + 1) * b].to(x.device) for (g, _), x in zip(self.replicas.shards, images)]

    # -- the step ----------------------------------------------------------

    def _reduce(self, grads: Params, metrics: Dict[str, torch.Tensor]):
        """The mean over the processes: gradients every process holds are
        all-reduced, blocks gathered across processes already carry every
        process's share (their gather's backward summed it)."""
        mesh = self.rt.mesh
        if mesh.process_count == 1:
            return grads, metrics
        whole = [g for n, g in grads.items()
                 if self.layout is None or not self.layout.spans_processes(ShardedParams.base_name(n))]
        all_reduce_(whole, mesh.group)
        for g in grads.values():
            g.div_(mesh.process_count)
        vals = list(metrics.values())
        all_reduce_(vals, mesh.group, dtype=torch.float64)  # scalars: summed in f64
        return grads, {k: v / mesh.process_count for k, v in metrics.items()}

    def __call__(self, state: TrainState, batch: Dict[str, Any]):
        cfg = self.cfg
        shards = as_row_shards(batch, self.rt)
        ins = {k: [t for _, t in v.shards] for k, v in shards.items()}
        params = self.params
        with self.towers.bound(hooks=self.hooks):
            img_args = (ins["images"],)
            if self.distill is None and cfg.image_mask_ratio > 0:
                img_args += (self.keep_idx(state.step, ins["images"]),)
            text = self.towers.tower("encode_text")
            towers = [(self.towers.tower("encode_image"), img_args), (text, (ins["query_ids"],)),
                      (text, (ins["target_ids"],))]
            if "neg_ids" in ins:
                towers.append((text, ([x.reshape(-1, x.shape[-1]) for x in ins["neg_ids"]],)))
            if self.distill is not None:
                teacher = [torch.stack([t.to(self.replicas.home) for t in ins[k]]) for k in ("t_img", "t_q", "t_t")]
                emb_loss, n_gc = functools.partial(self.distill, teacher=teacher), 0
            else:
                emb_loss, n_gc = self.emb_loss, int(cfg.grad_cache_chunks)
            if n_gc > 1:
                (_, metrics), grads = gradcache_value_and_grad(emb_loss, towers, params, n_gc)
            else:
                for p in params.values():
                    p.grad = None
                loss, metrics = emb_loss(*(enc(*a) for enc, a in towers))
                loss.backward()
                grads = collect_grads(params)
        grads, metrics = self._reduce(grads, {k: v.detach() for k, v in metrics.items()})
        state, metrics = apply_gradients(state, grads, metrics)
        if state.ema_params is not None:
            _ema_update(state.ema_params, params, cfg.ema_decay)
        return state, metrics


def init_state_gspmd(model: CLIP, cfg: TrainConfig, rt: MeshRuntime, steps_per_epoch: int) -> TrainState:
    """The GSPMD train state: the module's parameters cut into blocks over
    the mesh (``parallel.fsdp`` with ``rt.fsdp``, composed with
    ``parallel.tp`` where the model axis is active), AdamW's moments beside
    each block; the module's own parameters are released (the ``meta``
    device). :func:`init_state_fsdp` is this with ``rt.fsdp``."""
    from ..parallel.fsdp import fsdp_param_pspecs
    from ..parallel.tp import tp_param_pspecs

    named = {n: p.detach() for n, p in model.named_parameters()}
    base = tp_param_pspecs(named, rt.model_axis) if rt.mesh.shape[rt.model_axis] > 1 else None
    if rt.fsdp:
        specs = fsdp_param_pspecs(named, rt.mesh.shape[rt.data_axis], rt.data_axis, base=base)
    else:
        specs = base or {n: (None,) * p.ndim for n, p in named.items()}
    layout = ShardedParams(named, rt.mesh, specs)
    model.to("meta")
    ema = None
    if cfg.ema_decay > 0.0:
        ema = {n: b.detach().clone() for n, b in layout.leaves().items()}
    return TrainState(model, Optimizer(layout.leaves(), cfg, steps_per_epoch, layout=layout), 0, ema, None, layout)


def init_state_fsdp(model: CLIP, cfg: TrainConfig, rt: MeshRuntime, steps_per_epoch: int) -> TrainState:
    """ZeRO-3: parameters and both moments cut over the data axis."""
    return init_state_gspmd(model, cfg, dataclasses.replace(rt, fsdp=True), steps_per_epoch)


def make_train_step_gspmd(model: CLIP, cfg: TrainConfig, rt: MeshRuntime, layout: ShardedParams) -> Callable:
    """The train step over FSDP / tensor-parallel blocks (JAX
    ``make_train_step_gspmd``): each data shard builds the parameters from
    their blocks on its device a unit at a time, near their use, forward
    and backward (``parallel.fsdp.BlockGather``; the tensor-parallel
    projections stay cut, ``parallel.tp.tp_linear``), the loss scores the
    global batch (numerically the data-parallel step with
    ``global_negatives``), and each
    block's gradient is the sum over the shards of its uses, so each
    position updates only its own block."""
    return _ShardedStep(model, cfg, rt, layout=layout)


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


def _plans_on(plans: Any, device: torch.device) -> Any:
    """Encode plans (nested dicts and lists of tensors) on ``device``, no copy where they already are."""
    if isinstance(plans, dict):
        return {k: _plans_on(v, device) for k, v in plans.items()}
    if isinstance(plans, (list, tuple)):
        return type(plans)(_plans_on(v, device) for v in plans)
    return plans.to(device) if torch.is_tensor(plans) else plans


def make_encode_step(model: CLIP, rt: MeshRuntime, fast: bool = False, quantize: Optional[str] = None,
                     layout: Optional[ShardedParams] = None) -> Callable:
    """``step(params, images, query_ids, target_ids) -> (img, query, target)``
    over a mesh (JAX ``make_encode_step``): each data shard encodes its rows
    on its device and the L2-normalized embeddings come back gathered in
    global order, ``[N, D]`` on the mesh's first device, on every process.
    Inputs are this process's rows (or their ``RowShards``). ``params``:
    None (the module's own weights, or the ``layout``'s blocks), a view of
    the layout (the EMA shadow), or whole tensors by name (EMA, a LoRA
    merge). ``fast=True`` (implied by ``quantize``) runs the serving
    encoders (B1 / B3a / B3b on the card); its ``params`` are the encode
    plans (``{"visual": ..., "text": ...}``, as
    ``models.fast_encode.make_encode_plans`` returns them), moved to each
    shard's device, or None for plans packed once from the module for each
    distinct device; anything else raises ``ValueError``. Given a ``layout``
    (the GSPMD state) the parameters stay in their blocks, built a unit at a
    time (:func:`make_encode_step_gspmd`)."""
    from ..models.fast_encode import encode_image_fast, encode_text_fast, make_encode_plans

    fast = fast or quantize is not None
    home = rt.mesh.first_device
    devices = list(dict.fromkeys(d for _, d in rt.mesh.axis_shards(rt.data_axes)))
    own: Dict[torch.device, Any] = {}  # the module's plans, packed at the first call that wants them
    if fast:
        def fast_tower(fn, name: str) -> Callable:
            return lambda plans, xs: torch.stack(
                [l2_normalize(fn(model.arch, plans[x.device][name], x)).to(home) for x in xs])

        img, txt = fast_tower(encode_image_fast, "visual"), fast_tower(encode_text_fast, "text")
    else:
        towers = _ShardTowers(model, rt, layout)
        enc_img, enc_txt = towers.tower("encode_image"), towers.tower("encode_text")
        img, txt = (lambda _, xs: enc_img(xs)), (lambda _, xs: enc_txt(xs))

    @torch.no_grad()
    def step(params, images, query_ids, target_ids):
        plans = None
        if fast:
            if params is None:
                if not own:
                    model_home = next(model.parameters()).device
                    own.update({dev: make_encode_plans(model if dev == model_home else copy.deepcopy(model).to(dev),
                                                       dtype=model.dtype, quantize=quantize) for dev in devices})
                plans = own
            elif isinstance(params, dict) and set(params) == {"visual", "text"}:
                plans = {dev: _plans_on(params, dev) for dev in devices}
            else:
                raise ValueError("make_encode_step(fast=True) takes encode plans ({'visual': ..., 'text': ...}, "
                                 "as models.fast_encode.make_encode_plans returns them) or None, not "
                                 f"{type(params).__name__}")
        shards = as_row_shards({"images": images, "query_ids": query_ids, "target_ids": target_ids}, rt)
        ins = {k: [t for _, t in v.shards] for k, v in shards.items()}
        with contextlib.nullcontext() if fast else towers.bound(params):
            outs = (img(plans, ins["images"]), txt(plans, ins["query_ids"]), txt(plans, ins["target_ids"]))
        return tuple(all_gather_processes(o.reshape(-1, o.shape[-1]), rt.mesh) for o in outs)

    return step


def make_encode_step_gspmd(model: CLIP, rt: MeshRuntime, layout: ShardedParams) -> Callable:
    """The encode step over the GSPMD state: the parameters stay in their
    blocks, built a unit at a time on each shard's row (the tensor-parallel
    projections cut), never whole."""
    return make_encode_step(model, rt, layout=layout)


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
    """Epoch-loop orchestration. Without a mesh (``rt`` None and ``mesh`` of
    one device) it trains ``model``'s parameters in place on their device.
    Over a mesh runtime ``rt`` (or a ``mesh`` layout, built over ``cpu``
    repeated when the model is on the CPU) it runs the data-parallel step,
    or with a model axis or ``fsdp`` the GSPMD step over blocks (the
    module's own parameters are then released: :meth:`params` gathers the
    trained ones). Under ``torch.distributed`` every process runs it on its
    slice of each global batch."""

    def __init__(
        self,
        model: CLIP,
        train_data: DataPipeline,
        val_data: Optional[DataPipeline],
        cfg: TrainConfig,
        mesh: Optional[MeshConfig] = None,
        out_dir: str = "experiments/train",
        rt: Optional[MeshRuntime] = None,
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
        if rt is None and mesh is not None and (
                mesh.data_parallel * mesh.model_parallel * mesh.dcn_parallel > 1 or mesh.fsdp):
            from ..parallel.mesh import default_devices

            rt = MeshRuntime.create(mesh, default_devices(mesh, "cpu" if self.device.type == "cpu" else None))
        if rt is not None and rt.mesh.size == 1 and not rt.fsdp and rt.mesh.first_device == self.device:
            rt = None  # one device: the step of one device
        self.rt = rt
        if rt is not None and cfg.batch_size % rt.num_data:
            raise ValueError(f"train.batch_size={cfg.batch_size} must be divisible by the data-axis size "
                             f"({rt.num_data} devices)")
        self.tensor_parallel = rt is not None and rt.mesh.shape[rt.model_axis] > 1
        self.fsdp = rt is not None and rt.fsdp
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
        if self.lora:
            # adapter memory is ~0.1% of full fine-tuning: data parallelism covers it
            if self.tensor_parallel or self.fsdp:
                raise ValueError("lora_rank > 0 requires plain data parallelism (no tp/fsdp)")
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
            self.train_step = make_train_step(model, cfg, adapters, self.lora_scale, rt=rt)
            self.logger.info("LoRA rank %d (%s): %d trainable adapter params", cfg.lora_rank, cfg.lora_targets,
                             lora_param_count(adapters))
        elif cfg.distill_teacher:
            if self.tensor_parallel or self.fsdp:
                raise ValueError("distill_teacher requires plain data parallelism (no tp/fsdp)")
            # teacher embeddings precomputed offline ride the batch; the step swaps InfoNCE for the KD loss
            self.distill_bank = TeacherBank(load_encoded_dataset(cfg.distill_teacher))
            self.state = TrainState(model, make_optimizer(cfg, self.steps_per_epoch, model))
            self.train_step = make_distill_step(model, cfg, model.arch.embed_dim, self.distill_bank.dim, rt=rt)
            self.logger.info("distilling from %s (%d teacher rows, dim %d -> student dim %d)", cfg.distill_teacher,
                             len(self.distill_bank.enc.uuids), self.distill_bank.dim, model.arch.embed_dim)
        elif self.tensor_parallel or self.fsdp:
            # the GSPMD step scores the global batch whatever global_negatives says
            if not cfg.global_negatives:
                self.logger.warning("the GSPMD step computes global-batch negatives; "
                                    "cfg.global_negatives=False is ignored in tp/fsdp mode")
            self.state = (init_state_fsdp if self.fsdp else init_state_gspmd)(model, cfg, rt, self.steps_per_epoch)
            self.train_step = make_train_step_gspmd(model, cfg, rt, self.state.layout)
        else:
            optimizer = make_optimizer(cfg, self.steps_per_epoch, model)
            ema = {n: p.detach().clone() for n, p in model.named_parameters()} if self.ema else None
            self.state = TrainState(model, optimizer, 0, ema)
            self.train_step = make_train_step(model, cfg, rt=rt)
        if rt is not None:
            self.encode_step = make_encode_step(model, rt, layout=self.state.layout)
        self.stopper = EarlyStopper(cfg.early_stop_patience)
        self.start_epoch = 0
        if cfg.resume and ckpt.checkpoint_exists(cfg.checkpoint_dir, "latest"):
            self._resume()

    # -- checkpointing ------------------------------------------------------

    def _resume(self) -> None:
        # whole tensors by name: the state's own layout places them again
        state, meta = ckpt.load_checkpoint(self.cfg.checkpoint_dir, "latest")
        self.state.load_state_dict(state)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.stopper.best = float(meta.get("best_metric", -float("inf")))
        self.stopper.best_epoch = int(meta.get("best_epoch", -1))
        self.logger.info("resumed from epoch %d (best %.4f @ %d)", self.start_epoch, self.stopper.best,
                         self.stopper.best_epoch)

    def _save(self, role: str, epoch: int) -> None:
        # every process takes part in gathering the state, the coordinator writes
        multi = self.rt is not None and self.rt.mesh.process_count > 1
        ckpt.save_checkpoint(
            self.cfg.checkpoint_dir, role, self.state.state_dict(),
            {"epoch": epoch, "best_metric": self.stopper.best, "best_epoch": self.stopper.best_epoch}, wait=multi,
        )
        if multi:
            torch.distributed.barrier(self.rt.mesh.group)

    # -- data placement -----------------------------------------------------

    def _device_batch(self, batch: Batch) -> Dict[str, Any]:
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
        if self.rt is not None:
            return host_local_batch_to_global(host, self.rt.mesh, self.rt.data_axes)
        return {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in host.items()}

    # -- validation ---------------------------------------------------------

    def params(self) -> Params:
        """The trained parameters as whole tensors by name (every process
        calls it under ``torch.distributed``): the module's own, a LoRA run's
        adapters, or the GSPMD state's blocks joined."""
        return self.state.whole(self.state.params())

    def eval_params(self) -> Params:
        """The weights to evaluate and export: in a LoRA run the base merged
        with the current adapters (``W + s (a @ b)ᵀ``), the EMA shadow when
        ``ema_decay`` is set, else the trained parameters (whole tensors by
        name; every process calls it under ``torch.distributed``)."""
        if self.lora:
            with torch.no_grad():
                return lora_merge(dict(self.model.named_parameters()), self.state.adapters, self.lora_scale)
        if self.state.ema_params is not None:
            return self.state.whole(self.state.ema_params)
        if self.state.layout is not None:
            return self.params()
        return dict(self.model.named_parameters())

    def _encode_params(self):
        """What the encode step takes: None (the module's own weights), the
        GSPMD layout (or its EMA view), or whole tensors (a LoRA merge, EMA)."""
        layout = self.state.layout
        if self.lora:
            return self.eval_params()
        if self.state.ema_params is not None:
            return layout.view(self.state.ema_params) if layout is not None else self.state.ema_params
        return layout

    def validate(self) -> Dict[str, float]:
        """MRR-only validation over the whole validation split (T2I, T2T).
        Over a mesh each batch is padded to the global batch size, each
        process encodes its slice, and the gathered embeddings (global order,
        on every process) are cut back to the batch."""
        if self.val_data is None:
            return {}
        embs = {"img": [], "q": [], "t": []}
        if self.rt is None:
            # merged once a pass; None: the module's own weights
            params = self.eval_params() if (self.lora or self.state.ema_params is not None) else None
        else:
            params = self._encode_params()
        global_bs = self.cfg.batch_size
        with torch.no_grad():
            for batch in self.val_data.epoch_batches(global_bs, shuffle=False, drop_last=False):
                if self.rt is None:
                    db = self._device_batch(batch)
                    img, q, t = encode_batch(self.model, params, db["images"], db["query_ids"], db["target_ids"])
                else:
                    n = batch.images.shape[0]
                    arrays = [batch.images, batch.query_ids, batch.target_ids]
                    arrays = [np.pad(a, [(0, global_bs - n)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
                    pc, pi = self.rt.mesh.process_count, self.rt.mesh.process_index
                    local = global_bs // pc
                    arrays = [a[pi * local:(pi + 1) * local] for a in arrays]
                    img, q, t = (e[:n] for e in self.encode_step(params, *arrays))
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
            mesh = None if self.rt is None else self.rt.mesh
            batches = self.train_data.epoch_batches(cfg.batch_size, epoch=epoch, shuffle=True, seed=cfg.seed,
                                                    drop_last=True, num_shards=mesh.process_count if mesh else 1,
                                                    shard_index=mesh.process_index if mesh else 0)
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
