"""Offline corpus captioning (content-description generation).

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/datagen/captioning.py``,
the re-design of the reference's multi-GPU BLIP-2 captioning farm
(``src/data_generation/content_portion_generation.py``). The reference
spawns one process per GPU with shared task/result queues and poison pills
(``:44-283``); here one process drives batched generation, so the farm
collapses to:

- a :class:`Captioner` protocol (``generate(images) -> captions per image``;
  the 1-beam + 4-temperature-sampled recipe of ``:96-128`` belongs to the
  captioner implementation);
- :class:`CaptioningPipeline` — resume-by-skipping-existing-outputs
  (``:172-195``), batched generation, and per-uuid JSON persistence
  (``{uuid, content_descriptions}``, ``:222-265``).

Implementations: :class:`Blip2Captioner` (HF transformers, loaded lazily,
on the card by default) and :class:`FakeCaptioner` for offline tests. The
data-parallel :class:`MeshShardedCaptioner` waits for the parallel modes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Protocol, Sequence

import numpy as np


class Captioner(Protocol):
    def generate(self, images: Sequence[Any]) -> List[List[str]]:
        """Captions per image (the reference produces 5: 1 beam + 4 sampled)."""
        ...


class Blip2Captioner:
    """BLIP-2 captioner via HF transformers (reference ``:63-128``).

    Produces ``1 + len(temperatures)`` captions per image: one beam-search
    and one sampled caption per temperature.
    """

    def __init__(
        self,
        model_name: str = "Salesforce/blip2-opt-2.7b",
        temperatures: Sequence[float] = (0.3, 0.4, 0.5, 0.6),
        max_new_tokens: int = 50,
        device: str = "cuda",
    ):
        from transformers import AutoProcessor, Blip2ForConditionalGeneration

        self.processor = AutoProcessor.from_pretrained(model_name)
        self.model = Blip2ForConditionalGeneration.from_pretrained(model_name).to(device)
        self.model.eval()
        self.temperatures = list(temperatures)
        self.max_new_tokens = max_new_tokens
        self.device = device

    def generate(self, images: Sequence[Any]) -> List[List[str]]:
        import torch

        inputs = self.processor(images=list(images), return_tensors="pt").to(self.device)
        out: List[List[str]] = [[] for _ in images]
        with torch.no_grad():
            beam = self.model.generate(**inputs, num_beams=5, max_new_tokens=self.max_new_tokens)
            for i, text in enumerate(self.processor.batch_decode(beam, skip_special_tokens=True)):
                out[i].append(text.strip())
            for t in self.temperatures:
                sampled = self.model.generate(
                    **inputs, do_sample=True, temperature=t, max_new_tokens=self.max_new_tokens
                )
                for i, text in enumerate(self.processor.batch_decode(sampled, skip_special_tokens=True)):
                    out[i].append(text.strip())
        return out


class MeshShardedCaptioner:
    """Data-parallel captioning over a device mesh: the counterpart of the
    JAX package's one jitted program whose batch shards over the mesh's data
    axes. ``caption_fn(params, images [B, S, S, 3] f32) -> int [B, C, L]``
    token ids (C captions an image); ``decode_fn(ids [L]) -> str`` decodes
    one caption on the host. ``params`` (tensors, or dicts of them) are
    replicated once on each distinct mesh device; a batch is padded up to a
    multiple of the shard count by repeating its last image, each shard
    captioned on its own device, and the padding cut before decoding.
    Implements the :class:`Captioner` protocol, so :class:`CaptioningPipeline`
    (resume, persistence) is unchanged."""

    def __init__(self, caption_fn, params, decode_fn, rt):
        from ..parallel.sharding import replicate

        self.rt = rt
        self.caption_fn = caption_fn
        self.decode_fn = decode_fn
        self._shards = rt.mesh.axis_shards(rt.data_axes)
        self._n_shards = rt.num_data

        def on_each(tree):
            if isinstance(tree, dict):
                per = {k: on_each(v) for k, v in tree.items()}
                return {d: {k: v[d] for k, v in per.items()} for d in dict.fromkeys(rt.mesh.local_devices)}
            return replicate(tree, rt.mesh)

        self._params = on_each(params)

    def generate(self, images: Sequence[Any]) -> List[List[str]]:
        import torch

        from ..parallel.sharding import all_gather_processes, host_local_batch_to_global

        batch = np.stack([np.asarray(im, np.float32) for im in images])
        n = batch.shape[0]
        pad = (-n) % self._n_shards
        if pad:
            batch = np.concatenate([batch, np.repeat(batch[-1:], pad, axis=0)])
        pc, pi = self.rt.mesh.process_count, self.rt.mesh.process_index
        local = batch.shape[0] // pc
        shards = host_local_batch_to_global({"images": batch[pi * local:(pi + 1) * local]}, self.rt.mesh,
                                            self.rt.data_axes)["images"]
        with torch.no_grad():
            outs = [self.caption_fn(self._params[x.device], x).cpu() for _, x in shards.shards]
        ids = all_gather_processes(torch.cat(outs), self.rt.mesh).numpy()[:n]  # [n, C, L]
        return [[self.decode_fn(cap) for cap in row] for row in ids]


class FakeCaptioner:
    """Deterministic offline captioner for tests."""

    def __init__(self, num_captions: int = 5):
        self.num_captions = num_captions
        self.calls = 0

    def generate(self, images: Sequence[Any]) -> List[List[str]]:
        self.calls += 1
        return [
            [f"caption {v} for image {i} call {self.calls}" for v in range(self.num_captions)]
            for i in range(len(images))
        ]


@dataclass
class CaptioningPipeline:
    """Batched caption generation with resume + per-uuid persistence."""

    captioner: Captioner
    output_dir: str
    batch_size: int = 8

    def existing_uuids(self) -> set:
        out = Path(self.output_dir)
        if not out.exists():
            return set()
        return {f.stem for f in out.glob("*.json")}

    def run(self, uuids: Sequence[str], images: Sequence[Any]) -> Dict[str, List[str]]:
        """Caption every uuid not already on disk; returns progress summary."""
        if len(uuids) != len(images):
            raise ValueError("uuids and images must be aligned")
        out_dir = Path(self.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        done = self.existing_uuids()
        todo = [(u, im) for u, im in zip(uuids, images) if u not in done]

        written: List[str] = []
        for start in range(0, len(todo), self.batch_size):
            chunk = todo[start : start + self.batch_size]
            captions = self.captioner.generate([im for _, im in chunk])
            for (uuid, _), caps in zip(chunk, captions):
                with open(out_dir / f"{uuid}.json", "w", encoding="utf-8") as f:
                    json.dump({"uuid": uuid, "content_descriptions": caps}, f, indent=2, ensure_ascii=False)
                written.append(uuid)
        return {"written": written, "skipped": [u for u in uuids if u in done]}
