"""A benchmark root at toy sizes for the CPU tests: the real harness, the
real runners and checks, and configuration, traffic and limit files of
their own beside a ``BENCHMARK.json`` that names them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

TINY_CONFIG = {
    "source": "tiny CLIP for the CPU tests",
    "projection_dim": 32,
    "text_config": {"hidden_size": 64, "intermediate_size": 256, "num_attention_heads": 2, "num_hidden_layers": 2,
                    "max_position_embeddings": 77, "vocab_size": 49408},
    "vision_config": {"hidden_size": 64, "intermediate_size": 256, "num_attention_heads": 2, "num_hidden_layers": 2,
                      "image_size": 28, "patch_size": 14},
    "train_remat": False,
}

SEARCH = {
    "runner": "search_text", "corpus_rows": 3000, "batch": 8, "k": 5, "alpha": 0.5, "depth": 2,
    "quantize": "int8", "quantize_corpus": "int8", "int8": {"ff_group": 128},
    "merge_seed": 0, "common_words": 600, "rare_words": 400, "zipf_s": 1.0,
    "batch_mix": [{"bucket": 16, "batches": 2, "words": [2, 5]}, {"bucket": 32, "batches": 2, "words": [3, 14]},
                  {"bucket": 64, "batches": 1, "words": [8, 20], "numbers": [1, 2]},
                  {"bucket": 77, "batches": 1, "words": [16, 20], "numbers": [3, 4]}],
    "pool_batches": 8, "check": {"sample_every": 2},
}

TRAIN = {
    "runner": "train_step", "batch": 4, "records": 16, "source_aspect": [1.25, 1.0], "workers": 2,
    "query_words": [3, 8], "description_words": [15, 40], "numbers": [0, 0, 1],
    "merge_seed": 0, "common_words": 600, "rare_words": 400, "zipf_s": 1.0,
    "checked_steps": 3, "warmup_steps": 1,
    "recipe": {"lr": 1e-4, "weight_decay": 0.02, "beta1": 0.9, "beta2": 0.98, "eps": 1e-6, "epochs": 20,
               "eta_min_factor": 0.1, "temperature": 0.07, "t2i_weight": 0.7, "t2t_weight": 0.3,
               "grad_clip_norm": 1.0},
}

LIMITS = {
    "search": {"token_mismatch": 0, "malformed": 0, "emb_gap": 0.1, "score_gap": 0.03, "rank_gap": 0.03},
    "train": {"loss_gap": 0.02, "grad_gap": 0.1, "update_gap": 0.1},
}


def make_root(tmp: Path, bench: dict) -> Path:
    """``tmp`` as a benchmark root: a copy of ``port_bench`` with the tiny
    cells' files added and ``bench`` as its ``BENCHMARK.json``."""
    root = Path(tmp)
    shutil.copytree(HERE, root / "port_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "port_bench" / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (root / "port_bench" / "traffic" / "tiny.search.json").write_text(json.dumps(SEARCH))
    (root / "port_bench" / "traffic" / "tiny.train.json").write_text(json.dumps(TRAIN))
    (root / "port_bench" / "limits" / "tiny.search.json").write_text(json.dumps(LIMITS["search"]))
    (root / "port_bench" / "limits" / "tiny.train.json").write_text(json.dumps(LIMITS["train"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_bench() -> dict:
    """The real ``BENCHMARK.json`` with the tiny cells added."""
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "toy", "file": "port_bench/configs/tiny.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"] += [
        {"name": "tiny.search", "config": "tiny", "traffic": "tiny.search", "chips": 1, "why": "toy"},
        {"name": "tiny.train", "config": "tiny", "traffic": "tiny.train", "chips": 1, "why": "toy"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            src = [w for w in m["workloads"]]
            if any("search" in w for w in src):
                m["workloads"].append("tiny.search")
            if any("train" in w for w in src):
                m["workloads"].append("tiny.train")
    return bench
