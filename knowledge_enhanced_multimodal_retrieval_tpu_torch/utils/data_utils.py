"""Data splits, variant selection, and split persistence.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/utils/data_utils.py``
(pure host code). Parity with the reference's ``src/clip/utils/data_utils.py`` (SURVEY §2.18):

- :func:`get_data_splits` / :func:`stratified_splits` — stratified
  train/val/test split by ``object_type`` with small classes (< 3 samples)
  routed to train (``data_utils.py:15-112``); the core splitter here is
  mapping-based (``uuid -> type``) so it works for HF datasets and synthetic
  corpora, with a directory-scanning wrapper matching the reference CLI;
- :func:`select_text_variant` — deterministic per-(uuid, epoch) variant
  choice via a hashed RNG (``data_utils.py:115-158``);
- :func:`save_splits_to_json` / :func:`load_splits_from_json`
  (``data_utils.py:161-195``).
"""

from __future__ import annotations

import json
import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple


def stratified_splits(
    uuid_to_type: Mapping[str, str],
    test_size: float = 0.15,
    val_size: float = 0.1,
    min_samples_for_split: int = 3,
    random_seed: int = 42,
) -> Tuple[List[str], List[str], List[str]]:
    """Stratified train/val/test split over a ``uuid -> object_type`` map.

    Classes with fewer than ``min_samples_for_split`` members go entirely to
    train; the rest are split stratified by type with sklearn
    (``data_utils.py:79-112``). Returns ``(train, val, test)`` uuid lists.
    """
    from sklearn.model_selection import train_test_split

    type_counts: Dict[str, int] = defaultdict(int)
    for t in uuid_to_type.values():
        type_counts[t] += 1

    small_types = {t for t, c in type_counts.items() if c < min_samples_for_split}
    uuids = list(uuid_to_type)
    small = [u for u in uuids if uuid_to_type[u] in small_types]
    large = [u for u in uuids if uuid_to_type[u] not in small_types]

    if not large:
        train = list(small)
        random.Random(random_seed).shuffle(train)
        return train, [], []

    labels = [uuid_to_type[u] for u in large]
    train_val, test = train_test_split(large, test_size=test_size, random_state=random_seed, stratify=labels)
    tv_labels = [uuid_to_type[u] for u in train_val]
    train_large, val = train_test_split(
        train_val, test_size=val_size / (1 - test_size), random_state=random_seed, stratify=tv_labels
    )

    train = train_large + small
    random.seed(random_seed)
    random.shuffle(train)
    return train, val, test


def get_data_splits(
    images_dir: str,
    texts_dir: str,
    test_size: float = 0.15,
    val_size: float = 0.1,
    min_samples_for_split: int = 3,
    random_seed: int = 42,
) -> Tuple[List[str], List[str], List[str]]:
    """Directory-scanning wrapper: valid uuids are those with both a text
    JSON (carrying ``object_type``) and an image file (``data_utils.py:15-77``)."""
    texts = Path(texts_dir)
    images = Path(images_dir)
    text_uuids = {f.stem for f in texts.glob("*.json")}
    image_uuids = set()
    for ext in (".jpg", ".jpeg", ".png"):
        image_uuids.update(f.stem for f in images.glob(f"*{ext}"))
    valid = sorted(text_uuids & image_uuids)

    uuid_to_type: Dict[str, str] = {}
    for uuid in valid:
        try:
            with open(texts / f"{uuid}.json", encoding="utf-8") as f:
                obj_type = json.load(f).get("object_type") or "Unknown"
                uuid_to_type[uuid] = obj_type.strip() or "Unknown"
        except Exception:
            uuid_to_type[uuid] = "Unknown"

    return stratified_splits(uuid_to_type, test_size, val_size, min_samples_for_split, random_seed)


def select_text_variant(uuid: str, epoch: int, num_variants: int = 5, random_seed: int = 42) -> int:
    """Deterministic variant index for (uuid, epoch) (``data_utils.py:115-140``).

    Uses a digest-based seed rather than Python's ``hash`` (which is
    randomized per process for strings) so the choice is stable across runs.
    """
    import hashlib

    digest = hashlib.md5(f"{uuid}|{epoch}|{random_seed}".encode()).digest()
    seed = int.from_bytes(digest[:4], "little") % (2**31)
    return random.Random(seed).randint(0, num_variants - 1)


def get_text_variant_for_batch(
    uuids: Sequence[str], epoch: int, num_variants: int = 5, random_seed: int = 42
) -> List[int]:
    return [select_text_variant(u, epoch, num_variants, random_seed) for u in uuids]


def save_splits_to_json(
    train_uuids: Sequence[str], val_uuids: Sequence[str], test_uuids: Sequence[str], output_path: str
) -> None:
    """Persist splits (``data_utils.py:161-183``)."""
    splits = {
        "train": list(train_uuids),
        "val": list(val_uuids),
        "test": list(test_uuids),
        "train_size": len(train_uuids),
        "val_size": len(val_uuids),
        "test_size": len(test_uuids),
    }
    path = Path(output_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(splits, f, indent=2)


def load_splits_from_json(input_path: str) -> Tuple[List[str], List[str], List[str]]:
    with open(input_path, encoding="utf-8") as f:
        splits = json.load(f)
    return splits["train"], splits["val"], splits["test"]
