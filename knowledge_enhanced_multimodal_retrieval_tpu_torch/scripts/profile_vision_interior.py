"""Vision q8 kernel-interior experiments on one GPU.

Counterpart of ``scripts/profile_vision_interior.py`` of the reference
package. It times ISOLATED interior variants of the int8 vision layer at the
production ViT-L/14 vision shapes (batch 64, s = 257 padded to 272, width
1024, ff 4096, 16 heads, not causal), on layer 0 of a seeded
``make_vision_plan(quantize="int8")``, and prints seven medians:

  attention: production softmax vs the no-max-subtract diagnostic
  mlp:       production vs no-requant vs no-gelu-no-requant diagnostics
             (numerics differ: DIAGNOSTIC ONLY, they size the share of the
             softmax passes, the QuickGELU and the requantization)
  layer:     the per-block pair (B4a + B4b) vs the whole layer (B1)

Two kernels carry the variants, both in ``csrc/fused_block.cu``:

- :func:`attn_q8_variant` (S1) is B4a with a selectable interior: ``0`` the
  production softmax, ``1`` the same order of operations without the
  row-max pass (numerically unsafe for |logits| > ~80);
- :func:`mlp_q8_diag` (S2) is B4b with two switches: ``gelu`` and
  ``requant``. ``requant=False`` multiplies ``bf16(f)`` with a bf16 copy of
  the int8 c_proj chunk (exact), accumulates in f32 and scales by the weight
  scales after the product, with no activation quantization.

With interior 0, and with ``gelu = requant = True``, they equal
``ops.fused_block.fused_attention_block_q8`` / ``fused_mlp_block_q8`` bit
for bit: each runs the same function of the CUDA source. A CPU tensor runs
the plain versions (:func:`attn_q8_variant_plain`,
:func:`mlp_q8_diag_plain`); a CUDA tensor launches the kernel or raises.

Timing: CUDA events around ``--iters`` launches, the median of ``--reps``
such runs per line (on ``--device=cpu`` the host clock times the plain
versions: a check of the control flow, not a measurement of the card).

Run: python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.profile_vision_interior [--batch 64] [--iters 8] [--reps 7] [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import dispatch
from ..ops import fused_block as FB
from ..ops.dispatch import F, I, P

INTERIOR_PRODUCTION, INTERIOR_NOMAX = 0, 1

_ATTN_VARIANT_ARGS = [P] * 16 + [I] * 7 + [F, P]
_MLP_DIAG_ARGS = [P] * 20 + [I] * 6 + [F, P]


def attn_operands(lp):
    """The attention half's operands of an int8 layer plan, in B4a's order."""
    return (lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["wqkv_s"], lp["bqkv"], lp["wo"], lp["wo_s"], lp["bo"])


def mlp_operands(lp):
    """The MLP half's operands of an int8 layer plan, in B4b's order."""
    return (lp["ln2_scale"], lp["ln2_bias"], lp["w1"], lp["w1_s"], lp["b1"], lp["w2"], lp["w2_s"], lp["b2"])


def attn_k_major(lp):
    """``wqkv_qt`` / ``wo_qt`` keywords from a plan's K-major copies (absent
    ones are left for the wrapper to make)."""
    return dict(wqkv_qt=lp.get("wqkv_t"), wo_qt=lp.get("wo_t"))


def mlp_k_major(lp):
    """``w1_qt`` / ``w2_qt`` keywords from a plan's K-major copies."""
    return dict(w1_qt=lp.get("w1_t"), w2_qt=lp.get("w2_t"))


def _check_interior(interior: int) -> None:
    if interior not in (INTERIOR_PRODUCTION, INTERIOR_NOMAX):
        raise ValueError(f"interior must be 0 (production) or 1 (no-max softmax), got {interior!r}")


def attn_q8_variant_plain(x, lp, *, seq_len, heads, mask_len, interior, causal=False):
    """S1's plain version: B4a's, with the row-max pass of the softmax
    dropped when ``interior`` is 1."""
    _check_interior(interior)
    return FB._attn_half_q8(
        x, *attn_operands(lp), seq_len=seq_len, heads=heads, mask_len=mask_len, eps=1e-5, causal=causal,
        subtract_max=interior == INTERIOR_PRODUCTION,
    )


def mlp_q8_diag_plain(x, lp, *, gelu, requant, n_chunks=None):
    """S2's plain version: B4b's, with QuickGELU and the per-chunk
    requantization each switchable."""
    ff = lp["w1"].shape[1]
    n_chunks = FB.default_mlp_chunks(ff) if n_chunks is None else n_chunks
    return FB._mlp_half_q8(x, *mlp_operands(lp), n_chunks=n_chunks, eps=1e-5, gelu=bool(gelu), requant=bool(requant))


@dispatch.counted
def attn_q8_variant(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], *, seq_len: int, heads: int, mask_len: int, interior: int,
    causal: bool = False,
) -> torch.Tensor:
    """S1: the q8 attention block of layer plan ``lp`` with the softmax
    interior chosen by ``interior`` (0 production, 1 no-max-subtract)."""
    _check_interior(interior)
    width = lp["wqkv"].shape[0]
    FB._check_layout(x, width, seq_len, heads)
    if not dispatch.use_kernel(x):
        return attn_q8_variant_plain(
            x, lp, seq_len=seq_len, heads=heads, mask_len=mask_len, interior=interior, causal=causal
        )
    args = (x, *attn_operands(lp))
    FB._require_all(args, FB._attn_q8_specs(width, "1"))
    kt = FB._k_major_operands((lp["wqkv"], lp["wo"]), (lp.get("wqkv_t"), lp.get("wo_t")), ("wqkv_t", "wo_t"))
    out = torch.empty_like(x)
    scratch = (*FB._row_quant_scratch(x), *FB._attn_q8_scratch(x))
    fn = dispatch.kernel("kemr_attention_block_q8_variant", _ATTN_VARIANT_ARGS)
    status = fn(
        *[t.data_ptr() for t in (*args, *kt)], out.data_ptr(), *[t.data_ptr() for t in scratch],
        x.shape[0], width, heads, seq_len, mask_len, int(causal), int(interior), 1e-5, dispatch.stream_of(x),
    )
    dispatch.check(status, "attn_q8_variant")
    dispatch.count_launch(attn_q8_variant)
    return out


@dispatch.counted
def mlp_q8_diag(
    x: torch.Tensor, lp: Dict[str, torch.Tensor], *, gelu: bool, requant: bool, n_chunks: Optional[int] = None
) -> torch.Tensor:
    """S2: the q8 MLP block of layer plan ``lp`` with QuickGELU (``gelu``)
    and the per-chunk requantization (``requant``) each switchable."""
    width, ff = lp["w1"].shape
    if x.ndim != 2 or x.shape[1] != width:
        raise ValueError(f"x must be [rows, {width}], got {tuple(x.shape)}")
    n_chunks = FB.default_mlp_chunks(ff) if n_chunks is None else n_chunks
    FB._check_ff(ff, n_chunks)
    if not dispatch.use_kernel(x):
        return mlp_q8_diag_plain(x, lp, gelu=gelu, requant=requant, n_chunks=n_chunks)
    args = (x, *mlp_operands(lp))
    FB._require_all(args, FB._mlp_q8_specs(width, ff, "2"))
    kt = FB._k_major_operands((lp["w1"], lp["w2"]), (lp.get("w1_t"), lp.get("w2_t")), ("w1_t", "w2_t"))
    ck = ff // n_chunks
    out = torch.empty_like(x)
    scratch = (*FB._row_quant_scratch(x), *FB._mlp_q8_scratch(x, ff, n_chunks))
    # bf16 copies of one chunk of f and of c_proj: read only without requant
    fbf = torch.empty((x.shape[0], ck), dtype=torch.bfloat16, device=x.device)
    w2bf = torch.empty((ck, width), dtype=torch.bfloat16, device=x.device)
    fn = dispatch.kernel("kemr_mlp_block_q8_diag", _MLP_DIAG_ARGS)
    status = fn(
        *[t.data_ptr() for t in (*args, *kt)], out.data_ptr(), *[t.data_ptr() for t in scratch],
        fbf.data_ptr(), w2bf.data_ptr(), x.shape[0], width, ff, n_chunks, int(bool(gelu)), int(bool(requant)),
        1e-5, dispatch.stream_of(x),
    )
    dispatch.check(status, "mlp_q8_diag")
    dispatch.count_launch(mlp_q8_diag)
    return out


def _run_ms(fn: Callable[[], torch.Tensor], iters: int, device: torch.device) -> float:
    """ms per call over ``iters`` back-to-back calls."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Print the seven medians; returns ``{label: median ms}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..models import clip as M
    from ..models.fast_encode import _SEQ_MULTIPLE, make_vision_plan

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but PyTorch sees no CUDA device (pass --device=cpu for the plain versions)")
    model = M.build_model("ViT-L/14", dtype=torch.bfloat16, seed=0, device=device)
    arch = model.arch
    lp = make_vision_plan(model, quantize="int8")["layers"][0]
    del model
    width, heads = arch.vision_width, arch.heads_vision
    s = arch.grid_size**2 + 1
    s_pad = -(-s // _SEQ_MULTIPLE) * _SEQ_MULTIPLE
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((args.batch * s_pad, width)).astype(np.float32) * 0.02).to(device, torch.bfloat16)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        print(f"device {name}; x [{args.batch} x {s_pad}, {width}] bf16, heads {heads}, ff {lp['w1'].shape[1]}; "
              f"CUDA events, median of {args.reps} runs of {args.iters} launches")
    else:
        print(f"device cpu (plain versions, host clock: no measurement of a GPU); x [{args.batch} x {s_pad}, {width}]")

    medians: Dict[str, float] = {}

    def run(label: str, fn: Callable[[], torch.Tensor]) -> None:
        fn()  # warm-up: the kernel library loads on the first launch
        outs = [_run_ms(fn, args.iters, device) for _ in range(args.reps)]
        medians[label] = statistics.median(outs)
        print(f"{label:34s} median {medians[label]:7.3f} ms  (spread {min(outs):.3f}-{max(outs):.3f})", flush=True)

    attn_kw = dict(seq_len=s_pad, heads=heads, mask_len=s, causal=False)
    run("attn_q8 production softmax", lambda: attn_q8_variant(x, lp, interior=INTERIOR_PRODUCTION, **attn_kw))
    run("attn_q8 no-max-subtract softmax", lambda: attn_q8_variant(x, lp, interior=INTERIOR_NOMAX, **attn_kw))
    run("mlp_q8 prod (gelu+requant)", lambda: mlp_q8_diag(x, lp, gelu=True, requant=True))
    run("mlp_q8 no requant (w8a16 mm2)", lambda: mlp_q8_diag(x, lp, gelu=True, requant=False))
    run("mlp_q8 no gelu no requant", lambda: mlp_q8_diag(x, lp, gelu=False, requant=False))

    def per_block() -> torch.Tensor:
        y = FB.fused_attention_block_q8(x, *attn_operands(lp), **attn_kw, **attn_k_major(lp))
        return FB.fused_mlp_block_q8(y, *mlp_operands(lp), **mlp_k_major(lp))

    run("layer per-block pair (B4a + B4b)", per_block)
    run("layer whole-kernel (B1)", lambda: FB.fused_layer_q8(
        x, *attn_operands(lp), *mlp_operands(lp), **attn_kw, **attn_k_major(lp), **mlp_k_major(lp)))
    return medians


if __name__ == "__main__":
    main()
