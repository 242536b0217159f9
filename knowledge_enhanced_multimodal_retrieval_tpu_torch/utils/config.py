"""Typed configuration system (the port's own copy of the reference package's
``utils/config.py``: same dataclasses, same keys, same errors).

Replaces the reference's three-way duplication of hyperparameters across
argparse mains, bash scripts, and ``.env`` files (reference
``src/clip/train/trainer.py:528-582``, ``scripts/fine-tuning/train.sh:7-46``,
dotenv usage in ``src/retrieval.py:17-21`` — see SURVEY §2.16) with a single
source of truth: nested frozen dataclasses that can be

- constructed programmatically,
- loaded from / saved to JSON,
- overridden from ``--dotted.key=value`` CLI arguments,
- and have secret fields resolved from environment variables.

All configs are plain frozen Python objects, so they can be hashed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple, Type, TypeVar, get_args, get_origin

T = TypeVar("T")

# ---------------------------------------------------------------------------
# Generic dataclass <-> dict machinery
# ---------------------------------------------------------------------------


def to_dict(cfg: Any) -> dict:
    """Recursively convert a (possibly nested) dataclass config to a dict."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _convert(value: Any, typ: Any) -> Any:
    """Coerce ``value`` to annotated type ``typ`` (handles Optional, tuples,
    nested dataclasses, and string->scalar parsing for CLI overrides)."""
    origin = get_origin(typ)
    if origin is not None:
        args = get_args(typ)
        # Optional[X] / Union[X, None]
        if type(None) in args:
            if value is None or (isinstance(value, str) and value.lower() in ("none", "null", "")):
                return None
            inner = [a for a in args if a is not type(None)]
            return _convert(value, inner[0]) if len(inner) == 1 else value
        if origin in (tuple, Tuple):
            if isinstance(value, str):
                value = [v for v in value.replace("(", "").replace(")", "").split(",") if v != ""]
            if len(args) == 2 and args[1] is Ellipsis:
                return tuple(_convert(v, args[0]) for v in value)
            return tuple(_convert(v, a) for v, a in zip(value, args))
        if origin in (list, Sequence):
            if isinstance(value, str):
                value = [v for v in value.split(",") if v != ""]
            elem = args[0] if args else str
            return [_convert(v, elem) for v in value]
        if origin is dict:
            return dict(value)
        return value
    if is_dataclass(typ):
        if isinstance(value, typ):
            return value
        return from_dict(typ, value)
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def from_dict(cls: Type[T], data: Mapping[str, Any]) -> T:
    """Build dataclass ``cls`` from a mapping, recursing into nested configs."""
    kwargs = {}
    known = {f.name: f for f in fields(cls)}
    for key, value in data.items():
        if key not in known:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}; valid: {sorted(known)}")
        kwargs[key] = _convert(value, _resolve_type(cls, known[key]))
    return cls(**kwargs)


def _resolve_type(cls: type, f: dataclasses.Field) -> Any:
    """Resolve a field's type annotation, tolerating string annotations."""
    typ = f.type
    if isinstance(typ, str):
        import typing

        namespace = {**vars(typing), **globals()}
        try:
            typ = eval(typ, namespace)  # noqa: S307 - controlled input (our own annotations)
        except Exception:
            return Any
    return typ


def apply_overrides(cfg: T, overrides: Mapping[str, Any]) -> T:
    """Return a copy of ``cfg`` with dotted-key overrides applied.

    ``apply_overrides(cfg, {"train.lr": "1e-4", "model.name": "ViT-L/14"})``
    """
    data = to_dict(cfg)
    for dotted, value in overrides.items():
        node = data
        parts = dotted.split(".")
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"unknown config path {dotted!r} (at {p!r})")
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config path {dotted!r} (at {parts[-1]!r})")
        node[parts[-1]] = value
    return from_dict(type(cfg), data)


def parse_cli_overrides(argv: Sequence[str]) -> dict:
    """Parse ``--a.b=c`` / ``--a.b c`` style args into an override mapping."""
    out: dict = {}
    i = 0
    args = list(argv)
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            raise ValueError(f"unexpected positional argument {a!r}")
        a = a[2:]
        if "=" in a:
            k, v = a.split("=", 1)
        else:
            k = a
            if i + 1 < len(args) and not args[i + 1].startswith("--"):
                i += 1
                v = args[i]
            else:
                v = "true"  # bare flag
        out[k] = v
        i += 1
    return out


def load_json(cls: Type[T], path: str) -> T:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def save_json(cfg: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# Secrets / endpoints (reference .env usage: SURVEY §2.16)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Endpoints:
    """Remote service endpoints + secrets, resolved from the environment.

    Mirrors the reference's dotenv keys (``SPARQL_ENDPOINT[_KEY]``,
    ``MISTRAL_API_KEY``/``MISTRAL_AGENT_ID``, ``CIR_ENDPOINT[_KEY]``,
    ``HF_TOKEN`` — reference ``src/text2sparql/entity_linking.py:15-19``,
    ``src/text2sparql/text2sparql_retrieval.py:11-15``,
    ``src/retrieval.py:17-21``, ``src/clip/clip_retrieval.py:8``).
    """

    sparql_endpoint: Optional[str] = None
    sparql_endpoint_key: Optional[str] = None
    mistral_api_key: Optional[str] = None
    mistral_agent_id: Optional[str] = None
    cir_endpoint: Optional[str] = None
    cir_endpoint_key: Optional[str] = None
    hf_token: Optional[str] = None

    @staticmethod
    def from_env(env: Optional[Mapping[str, str]] = None) -> "Endpoints":
        e = os.environ if env is None else env
        return Endpoints(
            sparql_endpoint=e.get("SPARQL_ENDPOINT"),
            sparql_endpoint_key=e.get("SPARQL_ENDPOINT_KEY"),
            mistral_api_key=e.get("MISTRAL_API_KEY"),
            mistral_agent_id=e.get("MISTRAL_AGENT_ID"),
            cir_endpoint=e.get("CIR_ENDPOINT"),
            cir_endpoint_key=e.get("CIR_ENDPOINT_KEY"),
            hf_token=e.get("HF_TOKEN"),
        )


# ---------------------------------------------------------------------------
# Framework configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The reference's only parallelism is single-node
    data parallelism over NCCL (``trainer.py:44-49``); here DP is one axis of
    a general mesh so TP can be added without restructuring."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = all devices
    model_parallel: int = 1
    # Multi-slice data parallelism: a leading 'dcn' mesh axis for hybrid
    # DP across TPU slices (gradient reduction rides DCN between slices,
    # ICI within). Batches shard over (dcn, data) jointly; fsdp/tp stay
    # INSIDE a slice (the standard hybrid — weight gathers never cross
    # DCN). 1 = single slice (two-axis mesh, unchanged).
    dcn_parallel: int = 1
    dcn_axis: str = "dcn"
    # FSDP/ZeRO-3: shard params + optimizer moments over the data axis
    # (per-chip state memory scales 1/n; see parallel/fsdp.py)
    fsdp: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """CLIP variant selection (reference ``clip_model.py:15-44``)."""

    name: str = "ViT-B/32"  # ViT-B/32 | ViT-B/16 | ViT-L/14 | ViT-L/14@336px
    dtype: str = "bfloat16"  # compute dtype on the accelerator (params stay float32)
    checkpoint: Optional[str] = None  # path to converted params (orbax/npz)
    # LoRA adapters (train/lora.save_adapters .npz) merged into the params
    # at load: every CLI (serve/evaluate/precompute/export) then runs the
    # adapted model — the trained artifact per domain is just this file
    adapters: Optional[str] = None
    remat: bool = False  # recompute the tower blocks in the backward pass


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection + text handling (reference ``clip_dataset.py:21-185``)."""

    dataset: str = "xuemduan/reevaluate-image-text-pairs"
    split_train: str = "train"
    split_val: str = "validation"
    split_test: str = "test"
    max_text_words: int = 150  # word-level pre-truncation (clip_dataset.py:49-54)
    context_length: int = 77  # CLIP BPE context (hard ceiling)
    image_size: int = 224
    # "openai" (clip.load torchvision parity) | "hf" (CLIPImageProcessor
    # parity, for the published HF model — reference evaluator_hf.py:115-147)
    preprocess_mode: str = "openai"
    shuffle_buffer: int = 0
    num_workers: int = 8


@dataclass(frozen=True)
class TrainConfig:
    """Canonical fine-tuning config (reference ``scripts/fine-tuning/train.sh:7-46``,
    ``trainer.py:479-492``)."""

    batch_size: int = 64  # per-device
    epochs: int = 20
    lr: float = 5e-6
    weight_decay: float = 0.02
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    eta_min_factor: float = 0.1  # cosine anneal floor = factor * lr
    # linear LR warmup over this many optimizer steps before the cosine
    # (0 = reference parity: full lr from step one, ``trainer.py:488-492``)
    warmup_steps: int = 0
    # exponential moving average of the trained params (0 = off): the step
    # updates ``ema = decay * ema + (1 - decay) * params`` per train step
    # (per micro-batch under grad_accum_steps — pick decay accordingly);
    # validation / best-checkpoint selection / export then use the EMA
    # weights, the standard production smoothing for contrastive training.
    # DP and tp/fsdp steps only (lora/distill refuse the combination).
    ema_decay: float = 0.0
    temperature: float = 0.07
    t2i_weight: float = 0.7
    t2t_weight: float = 0.3
    # contrastive objective: "infonce" (reference parity) or "siglip"
    # (pairwise sigmoid, Zhai et al. 2023 — no softmax normalization, so
    # global negatives cost one all_gather; pair with temperature~0.1)
    loss: str = "infonce"
    sigmoid_bias: float = -10.0  # siglip negative-imbalance offset
    # Matryoshka Representation Learning (train/losses.py): average the
    # contrastive loss over these embedding-prefix widths (full width is
    # always appended) so prefixes serve as standalone embeddings —
    # consumed by CLIPRetrieval(truncate_dim=d) / eval.truncate_dim
    matryoshka_dims: Tuple[int, ...] = ()
    # Mined hard negatives (train/negatives.py, cli.mine_negatives): path to
    # a mined [N, M] index table; each batch example adds its top
    # hard_negatives_k mined examples' TARGET TEXTS to both joint-loss
    # denominators (extra competition, never labels). "" = off.
    hard_negatives: str = ""
    hard_negatives_k: int = 4
    # GradCache (train/gradcache.py, Gao et al. 2021): encode each tower in
    # this many chunks per step (0/1 = off) — activation memory scales 1/C
    # at ~2x encoder forward cost while the contrastive negative pool keeps
    # the FULL batch (grad_accum_steps shrinks the pool; this doesn't).
    # Gradients are math-identical to the direct step. Must divide the
    # per-shard batch.
    grad_cache_chunks: int = 0
    # FLIP-style masked image training (Li et al. 2022): drop this fraction
    # of patch tokens per image in the TRAIN forward (static token count,
    # class token kept, eval/serving unmasked) — vision-tower train FLOPs
    # scale by (1 - ratio); FLIP found 0.5 near-lossless for CLIP objectives
    image_mask_ratio: float = 0.0
    # quantization-aware training (train/qat.py): the forward fake-quantizes
    # projection weights (per-output-channel int8) and their inputs
    # (per-row dynamic int8) through straight-through estimators — the same
    # roundings eval.encoder=int8 serving applies, so deployment
    # quantization is loss-aware. Checkpoints stay full-precision f32.
    qat: bool = False
    grad_accum_steps: int = 1
    grad_clip_norm: float = 1.0
    early_stop_patience: int = 5
    early_stop_metric: str = "avg_mrr"  # avg_mrr | t2i_mrr | t2t_mrr
    seed: int = 42
    freeze_image_encoder: bool = False
    freeze_text_encoder: bool = False
    global_negatives: bool = False  # all_gather negatives across the mesh (opt-in improvement)
    # LoRA low-rank adaptation (train/lora.py): 0 = full fine-tune
    # (reference behavior); > 0 trains rank-r adapters on the transformer
    # projections instead — tiny optimizer state, tiny shippable artifact
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: str = "attn"  # attn | mlp | all
    # knowledge distillation (train/distill.py): path to a teacher
    # EncodedDataset .npz (save_encoded_dataset). When set, the train step
    # matches the student's similarity geometry to the teacher's instead of
    # running InfoNCE — the serving path to a smaller/faster tower.
    distill_teacher: str = ""
    distill_kd_weight: float = 1.0  # similarity-matrix KL weight
    distill_embed_weight: float = 0.5  # direct cosine loss (needs equal dims)
    checkpoint_dir: str = "checkpoints"
    resume: bool = False
    # preemption-safe training: install a SIGTERM handler (TPU maintenance
    # events / spot reclaims deliver SIGTERM with a grace window) and, at
    # the next step boundary, drain — save a resumable "latest" checkpoint
    # and return cleanly with {"preempted": True}. Multi-process runs agree
    # on the drain collectively so train-step collectives never desync.
    preempt_save: bool = True
    # steps between preemption-flag checks; on multi-process meshes each
    # check is one tiny all-gather, so keep it coarse (single-process
    # checks are free). 0 disables mid-epoch checks (epoch ends only).
    preempt_check_every: int = 20
    log_every: int = 50
    wandb_project: Optional[str] = None  # optional wandb logging (trainer.py:117-131)


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation config (reference ``evaluator.py:260-296``)."""

    batch_size: int = 256
    ks: Tuple[int, ...] = (1, 5, 10, 20)
    t2i_weight: float = 0.5
    t2t_weight: float = 0.5
    seed: int = 42
    output_dir: str = "experiments"
    # encoder path for encode/precompute/serve: "flax" (exact), "fast"
    # (fused bf16 Pallas kernels), or "int8" (fused W8A8 — fastest, ~1%
    # scores)
    encoder: str = "flax"
    # pack the serving corpus: "" = exact, "int8"/"true" = per-row int8
    # (half the HBM footprint), "int4" = nibble-packed int4 (quarter),
    # "pq" = product-quantization codes (~30x — binary footprint at far
    # better recall), "binary" = sign sketches (32x; rerank mandatory)
    quantize_corpus: str = ""
    # product-quantization subspace count (0 = dim/8); must divide the
    # staged embedding width
    pq_m: int = 0
    # score-aware (anisotropic / ScaNN-objective) PQ training: weight the
    # residual parallel to each row by eta(t) — halves the score error on
    # the true winners at equal bitrate; 0 = off, 0.2 = standard
    pq_aniso_t: float = 0.0
    # shard the serving corpus over the mesh data axis (capacity scales
    # linearly with device count; composes with quantize_corpus)
    shard_corpus: bool = False
    # shard query batches over the mesh data axis instead (corpus + params
    # replicate on every device): serving THROUGHPUT scales linearly with
    # device count — the dual of shard_corpus; mutually exclusive with it
    shard_queries: bool = False
    # ANN mode for serving: "" = exact brute force (default), "ivf" =
    # cluster probing (retrieval/ann.py — sublinear HBM traffic per query)
    ann: str = ""
    ann_nlist: int = 0  # 0 = sqrt(corpus size)
    ann_nprobe: int = 8
    # disk cache for the built IVF index: loaded when fresh (corpus
    # fingerprint checked), rebuilt + re-saved otherwise
    ann_index: str = ""
    # IVF-PQ wide-probe budget: searches whose estimated ADC lookup count
    # (batch * nprobe * cap * m) exceeds this raise instead of silently
    # serving at ~1e8 lookups/s (scalarized gather). 0 disables the guard.
    ann_max_batch_lookups: float = 1e7
    # round serving-corpus device rows up to this multiple so live corpus
    # updates within a bucket reuse the compiled search program (1 = exact
    # current-size arrays)
    capacity_multiple: int = 1
    # host-side exact rerank of the device top candidates (two-tier
    # serving: packed corpus on-chip, f32 rows in host RAM rescore the
    # winners); rerank_factor x k candidates are fetched per query
    rerank: bool = False
    rerank_factor: int = 4
    # memory-map the store's tower arrays instead of reading them into RAM
    # (for corpora near the host-memory budget; packed serving modes only
    # ever stream-read the f32 rows)
    mmap_store: bool = False
    # persistent jax compilation-cache directory ("" = off): restarted
    # processes load compiled executables from disk instead of paying the
    # (minutes-long on a relay backend) remote recompile — see
    # ops.dispatch.enable_compile_cache
    compile_cache: str = ""
    # Matryoshka serving (0 = off): scan the corpus at the first N embedding
    # dims (prefix re-normalized on host before packing/upload — HBM and
    # candidate-scan cost scale with N); pair with rerank for full-dim
    # final scores. Meaningful for MRL-trained models (train.matryoshka_dims)
    truncate_dim: int = 0
    # rotated quantization (packed corpus modes only): rotate corpus rows
    # and query embeddings by a seeded random orthonormal matrix — exact
    # scores are invariant, but int4/int8 grids and binary sketches lose
    # far less recall on anisotropic embeddings (the LSH/OPQ trick)
    rotate: bool = False
    rotate_seed: int = 0
    # rotation mode: "random" (seeded Haar rotation, any packed mode) or
    # "opq" (learned PQ-reconstruction rotation, quantize_corpus="pq" only
    # — ops.pq.train_opq_rotation)
    rotate_mode: str = "random"


def resolve_encoder(encoder: str):
    """Validate ``eval.encoder`` and map it to ``(use_fast, quantize)``.

    The single source of truth for the encoder whitelist — evaluate,
    precompute, and serve all route through this so the same flag value
    behaves identically at every entry point."""
    if encoder not in ("flax", "fast", "int8"):
        raise ValueError(f"unknown eval.encoder {encoder!r}: expected flax|fast|int8")
    return encoder in ("fast", "int8"), "int8" if encoder == "int8" else None


def resolve_quantize_corpus(value: str):
    """Map ``eval.quantize_corpus`` to the :class:`CLIPRetrieval` mode.

    Accepts the packing names (``"int8"``/``"int4"``) plus boolean spellings
    for backward compatibility with the original on/off flag (``"true"`` =
    int8). Single source of truth for serve and any future entry point.
    """
    v = str(value).strip().lower()
    if v in ("", "0", "false", "no", "off", "none"):
        return False
    if v in ("1", "true", "yes", "on", "int8"):
        return "int8"
    if v in ("int4", "pq", "binary"):
        return v
    raise ValueError(
        f"unknown eval.quantize_corpus {value!r}: "
        "expected ''|true|int8|int4|pq|binary"
    )


@dataclass(frozen=True)
class FusionConfig:
    """Serving-time CLIP x SPARQL fusion defaults (reference ``src/retrieval.py:79``)."""

    alpha: float = 0.8  # CLIP score weight
    beta: float = 0.2  # SPARQL membership bonus
    alpha_clip: float = 0.5  # T2I/T2T blend inside CLIP retriever
    threshold: float = 0.0
    # learned-fusion serving (TPU-native extension; the reference trains
    # heads but never serves them): head type for cli.train_fusion, trained
    # artifact path for serving, and the stage-1 candidate over-fetch factor
    head: str = "simple_gated"
    head_params: str = ""
    factor: int = 4


@dataclass(frozen=True)
class Config:
    """Top-level framework config."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def config_from_argv(argv: Sequence[str], base: Optional[Config] = None) -> Config:
    """Build a :class:`Config` from CLI args.

    Supports ``--config path.json`` to load a base file plus any number of
    dotted overrides (``--train.lr=1e-5``).
    """
    args = list(argv)
    cfg = base or Config()
    if "--config" in args:
        i = args.index("--config")
        cfg = load_json(Config, args[i + 1])
        del args[i : i + 2]
    overrides = parse_cli_overrides(args)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg
