"""Hybrid target-text generation: merge metadata + content captions.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/datagen/texts.py``
(host code, unchanged).

Parity with ``src/data_generation/texts_generation.py`` (SURVEY §2.19b), as
importable functions instead of a run-on-import script:

- :func:`combine_descriptions` — concatenate content + metadata with
  lead-in dedup heuristics ("This is a painting/church/Temples" etc.,
  ``texts_generation.py:1-46``);
- :func:`random_select_content` — quality-filtered random caption selection
  (drops "the church of the person" artifacts and <10-char strings,
  ``texts_generation.py:49-67``);
- :func:`build_hybrid_texts` — iterate the intersection of metadata /
  content / image uuid sets and write per-uuid ``{uuid, target_text}`` JSON
  (``texts_generation.py:69-103``), with deterministic seeding.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple


def combine_descriptions(metadata: str, content: str) -> str:
    """Merge a metadata sentence with a content caption, deduplicating
    duplicate object-type lead-ins."""
    if metadata and content:
        first_part = metadata.split(",")[0]
        lead = None
        if first_part.startswith("This is a"):
            lead = first_part.split("This is a")[-1].strip()
        elif first_part.startswith("A "):
            lead = first_part.split("A ")[-1].strip()
        if lead is not None and lead.lower() in content:
            hybrid = content + metadata.split(first_part)[-1].strip()
        else:
            hybrid = content + ". " + metadata
    elif metadata:
        hybrid = metadata
    elif content:
        hybrid = content
    else:
        hybrid = ""

    if hybrid:
        hybrid = hybrid[0].upper() + hybrid[1:]

    for noun in ("painting", "church", "temples"):
        if noun in content:
            cap = "Temples" if noun == "temples" else noun
            hybrid = hybrid.replace(f". This is a {cap}", ",")
            hybrid = hybrid.replace(f". A {cap}", ",")
    return hybrid


_BAD_PHRASE = "the church of the person"


def random_select_content(
    content_descriptions: List[str], rng: Optional[random.Random] = None
) -> Tuple[str, str]:
    """Pick two quality-filtered captions (destructive on the input list)."""
    rng = rng or random

    def pick() -> str:
        while content_descriptions:
            c = rng.choice(content_descriptions)
            if _BAD_PHRASE in c or len(c) < 10:
                content_descriptions.remove(c)
                continue
            content_descriptions.remove(c)
            return c
        return ""

    c1 = pick()
    if not c1:
        return "", ""
    c2 = pick()
    return c1, c2


def build_hybrid_texts(
    metadata_dir: str,
    content_dir: str,
    images_dir: str,
    output_dir: str,
    seed: int = 42,
) -> Dict[str, List[str]]:
    """Merge per-uuid metadata + content JSON into ``{uuid, target_text}``
    files for every uuid present in all three sources.

    Returns ``{"written": [...], "errors": [...]}`` where errors are uuids
    with an empty side (still written, matching the reference)."""
    rng = random.Random(seed)
    meta_uuids = {f.split(".")[0] for f in os.listdir(metadata_dir)}
    content_uuids = {f.split(".")[0] for f in os.listdir(content_dir)}
    image_uuids = {f.split(".")[0] for f in os.listdir(images_dir)}
    uuids = sorted(meta_uuids & content_uuids & image_uuids)

    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: List[str] = []
    errors: List[str] = []
    for uuid in uuids:
        with open(Path(metadata_dir) / f"{uuid}.json", encoding="utf-8") as f:
            metadata = rng.choice(json.load(f)["metadata_descriptions"])
        with open(Path(content_dir) / f"{uuid}.json", encoding="utf-8") as f:
            content = rng.choice(json.load(f)["content_descriptions"])
        if not content or not metadata:
            errors.append(uuid)
        target = combine_descriptions(metadata, content)
        with open(out_dir / f"{uuid}.json", "w", encoding="utf-8") as f:
            json.dump({"uuid": uuid, "target_text": target}, f, indent=2, ensure_ascii=False)
        written.append(uuid)
    return {"written": written, "errors": errors}
