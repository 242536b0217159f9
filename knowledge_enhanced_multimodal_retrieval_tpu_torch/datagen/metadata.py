"""Metadata-description generation.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/datagen/metadata.py``
(host code, unchanged).

The reference's ``src/data_generation/metadata_portion_generation.py`` is an
empty file — the generator that produced ``metadata_descriptions`` was never
released (SURVEY §2.19c). This module supplies a working equivalent: a
deterministic template engine that renders an artefact's KG metadata fields
into several natural-language variants, matching the downstream contract the
rest of the pipeline consumes (``{uuid, metadata_descriptions: [str, ...]}``
JSON files read by ``datagen/texts.py`` and ``baselines/text_models.py``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Sequence


_TEMPLATES = (
    "This is a {object_type}{creator_c}{date_c}{material_c}{location_c}.",
    "A {object_type}{creator_c}{date_c}{location_c}{material_c}.",
    "{Object_type}{creator_by}{date_from}{material_made}{location_held}.",
    "{title_lead}a {object_type}{creator_c}{date_c}{material_c}.",
    "{Object_type}{date_from}{creator_by}{location_held}{material_made}.",
)


def _clauses(meta: Mapping[str, str]) -> Dict[str, str]:
    object_type = (meta.get("object_type") or "artefact").strip().lower()
    title = (meta.get("title") or "").strip()
    creator = (meta.get("creator") or "").strip()
    date = str(meta.get("date") or "").strip()
    material = (meta.get("material") or "").strip()
    location = (meta.get("location") or "").strip()
    return {
        "object_type": object_type,
        "Object_type": ("A " + object_type) if object_type else "An artefact",
        "title_lead": f"'{title}', " if title else "",
        "creator_c": f", created by {creator}" if creator else "",
        "creator_by": f" by {creator}" if creator else "",
        "date_c": f", dated {date}" if date else "",
        "date_from": f" from {date}" if date else "",
        "material_c": f", made of {material}" if material else "",
        "material_made": f", made of {material}" if material else "",
        "location_c": f", held in {location}" if location else "",
        "location_held": f", held in {location}" if location else "",
    }


def generate_metadata_descriptions(
    metadata: Mapping[str, str],
    num_variants: int = 5,
) -> List[str]:
    """Render ``num_variants`` description variants from metadata fields.

    Deterministic: same metadata -> same variants (templates cycle)."""
    clauses = _clauses(metadata)
    out: List[str] = []
    for i in range(num_variants):
        text = _TEMPLATES[i % len(_TEMPLATES)].format(**clauses)
        text = " ".join(text.split())  # collapse double spaces from empty clauses
        text = text.replace(" ,", ",").replace(",.", ".").replace(" .", ".")
        out.append(text)
    return out


def build_metadata_texts(
    records: Sequence[Mapping[str, str]],  # each needs 'uuid' + metadata fields
    output_dir: str,
    num_variants: int = 5,
) -> List[str]:
    """Write per-uuid ``{uuid, metadata_descriptions}`` JSON files."""
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written: List[str] = []
    for rec in records:
        uuid = rec["uuid"]
        descriptions = generate_metadata_descriptions(rec, num_variants)
        with open(out_dir / f"{uuid}.json", "w", encoding="utf-8") as f:
            json.dump({"uuid": uuid, "metadata_descriptions": descriptions}, f, indent=2, ensure_ascii=False)
        written.append(uuid)
    return written
