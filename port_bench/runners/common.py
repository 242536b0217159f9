"""What the runners share: the program's CLIP built from the harness's
weights, and the query maker of a traffic mix."""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import torch

from .. import gen
from ..reference.bpe import Tokenizer


def port_model(a: gen.Arch, weights: Dict[str, torch.Tensor], dtype=torch.bfloat16, remat: bool = False):
    """The program's ``CLIP`` holding ``weights`` (no host-side init: the
    module is built on the meta device and takes the tensors as they are)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as port_clip

    arch = port_clip.CLIPArch(
        embed_dim=a.embed_dim, image_resolution=a.image_resolution, vision_layers=a.vision_layers,
        vision_width=a.vision_width, vision_patch_size=a.vision_patch_size, context_length=a.context_length,
        vocab_size=a.vocab_size, text_width=a.text_width, text_heads=a.text_heads, text_layers=a.text_layers,
        vision_heads=a.vision_heads,
    )
    with torch.device("meta"):
        model = port_clip.CLIP(arch, dtype, remat)
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def vocabulary(traffic: dict) -> Tuple[List[Tuple[str, str]], gen.QueryMaker, Tokenizer]:
    """The mix's merge table, its query maker (each word's token count from
    the reference tokenizer) and that tokenizer."""
    words, rare, merges = gen.word_list(traffic["merge_seed"], traffic["rare_words"])
    tok = Tokenizer(merges)
    vocab = words[: traffic["common_words"]] + rare[: traffic["rare_words"]]
    counts = [tok.count(w) - 2 for w in vocab]
    return merges, gen.QueryMaker(vocab, counts, traffic["zipf_s"]), tok


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
