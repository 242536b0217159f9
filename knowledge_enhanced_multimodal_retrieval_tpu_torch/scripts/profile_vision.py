"""Break the vision-tower encode down: embed + pool, per layer, per block.

Counterpart of the reference's ``scripts/profile_vision.py``, at the port's
launch shapes: a seeded ``--model`` (ViT-L/14 by default) vision tower on
``--batch`` random images; the sequence (257 tokens at ViT-L/14) pads to
the next multiple of 16 (``models.fast_encode``: 272 rows a sequence, the
pad keys masked).

- For the bf16 plan (B3a + B3b a layer) and the int8 plan (B1 a layer):
  ``encode_image_fast`` with 0, half and all of the layers; ``embed_pool``
  is the 0-layer time and ``per_layer`` the slope between half and all.
- Layer 0's kernels alone on ``[batch * 272, 1024]`` rows: B4a
  (``attn_q8``), B3a (``attn_bf16``), B4b (``mlp_q8``), B3b
  (``mlp_bf16``) and B1 (``layer_q8``, the whole int8 layer), with the
  B4a + B4b sum beside B1. The reference's MLP row-tile sweep has no
  counterpart: the port's kernels take no tile argument.

Each line: event and device-only medians (``scripts.timing``) and the
kernel launches of one call.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_vision \
        [--batch 64] [--iters 8] [--device cuda] [--out PATH]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cli.common import resolve_device
from ..models import clip as M
from ..models import fast_encode as FE
from ..ops import fused_block as FB
from .timing import card, default_out, launches_of, ms_of, time_ms, write_json

DEFAULT_OUT = default_out("profile_vision.json")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    model = M.build_model(args.model, dtype=torch.bfloat16, seed=0, device=dev)
    arch = model.arch
    rng = np.random.default_rng(0)
    r = arch.image_resolution
    images = torch.as_tensor(rng.standard_normal((args.batch, r, r, 3)).astype(np.float32), device=dev)
    plans = {"bf16": FE.make_vision_plan(model), "int8": FE.make_vision_plan(model, quantize="int8")}
    n_layers = len(plans["bf16"]["layers"])

    def line(name, fn, out):
        t = time_ms(fn, dev, iters=args.iters)
        out[name] = {**t, "launches": launches_of(fn, dev)}
        print(f"{name:22s} " + " ".join(f"{key} {v:8.3f}" for key, v in t.items()), flush=True)
        return t

    towers = {}
    for mode, plan in plans.items():
        rows = {}
        times = {}
        for cnt in (0, n_layers // 2, n_layers):
            sub = dict(plan, layers=plan["layers"][:cnt])
            times[cnt] = line(f"{mode} layers={cnt}", lambda sub=sub: FE.encode_image_fast(arch, sub, images), rows)
        span = n_layers - n_layers // 2
        per_layer = {key: (times[n_layers][key] - times[n_layers // 2][key]) / span for key in times[n_layers]}
        towers[mode] = {"lines": rows, "full": times[n_layers], "embed_pool": times[0], "per_layer": per_layer,
                        "images_per_s": args.batch / ms_of(times[n_layers]) * 1e3}
        print(f"{mode}: full {ms_of(times[n_layers]):.3f} ms ({towers[mode]['images_per_s']:.1f} img/s), "
              f"embed+pool {ms_of(times[0]):.3f} ms, per layer {ms_of(per_layer):.4f} ms", flush=True)

    # layer 0's kernels alone at the tower's launch shape
    width, heads = arch.vision_width, arch.heads_vision
    s = arch.grid_size ** 2 + 1
    s_pad = -(-s // FE._SEQ_MULTIPLE) * FE._SEQ_MULTIPLE
    x = torch.as_tensor(rng.standard_normal((args.batch * s_pad, width)).astype(np.float32), device=dev).bfloat16()
    q8, bf = plans["int8"]["layers"][0], plans["bf16"]["layers"][0]
    attn_kw = dict(seq_len=s_pad, heads=heads, mask_len=s, causal=False)
    blocks = {}
    kernels = {
        "attn_q8": lambda: FB.fused_attention_block_q8(
            x, q8["ln1_scale"], q8["ln1_bias"], q8["wqkv"], q8["wqkv_s"], q8["bqkv"], q8["wo"], q8["wo_s"], q8["bo"],
            wqkv_qt=q8["wqkv_t"], wo_qt=q8["wo_t"], **attn_kw),
        "attn_bf16": lambda: FB.fused_attention_block(
            x, bf["ln1_scale"], bf["ln1_bias"], bf["wqkv"], bf["bqkv"], bf["wo"], bf["bo"], **attn_kw),
        "mlp_q8": lambda: FB.fused_mlp_block_q8(
            x, q8["ln2_scale"], q8["ln2_bias"], q8["w1"], q8["w1_s"], q8["b1"], q8["w2"], q8["w2_s"], q8["b2"],
            w1_qt=q8["w1_t"], w2_qt=q8["w2_t"]),
        "mlp_bf16": lambda: FB.fused_mlp_block(
            x, bf["ln2_scale"], bf["ln2_bias"], bf["w1"], bf["b1"], bf["w2"], bf["b2"]),
        "layer_q8": lambda: FE._apply_layers(x, [q8], s_pad=s_pad, heads=heads, mask_len=s, causal=False),
    }
    times = {name: line(name, fn, blocks) for name, fn in kernels.items()}
    pair = {key: times["attn_q8"][key] + times["mlp_q8"][key] for key in times["attn_q8"]}
    print(f"attn_q8 + mlp_q8 {ms_of(pair):.3f} ms | layer_q8 {ms_of(times['layer_q8']):.3f} ms", flush=True)
    payload = {"script": "profile_vision", "device": str(dev), "card": card(dev), "model": args.model,
               "batch": args.batch, "rows": args.batch * s_pad, "seq_len": s, "seq_pad": s_pad, "width": width,
               "iters": args.iters, "towers": towers, "blocks": blocks, "attn_q8_plus_mlp_q8": pair}
    write_json(payload, args.out)
    return payload


if __name__ == "__main__":
    main()
