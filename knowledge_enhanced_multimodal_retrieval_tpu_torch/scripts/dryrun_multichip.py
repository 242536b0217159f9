"""Dry run of parallel training and sharded serving over an n-device mesh.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.dryrun_multichip \
        [--devices 8] [--device cuda|cpu]

The port's counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``.
Training first, on a tiny CLIP (f32, global negatives, batch 2 a shard):
the data-parallel step, LoRA over it, dp x tp2 (GSPMD), dp2 x pp2
(pipelined text blocks, forward and gradients), sp4 (a ring-attention
block, forward and input gradient), FSDP (ZeRO-3 blocks), dcn2 x dp (equal
to the flat data-parallel loss to 1e-4) and ep4 (an expert-sharded MoE,
forward and gradients); each loss must be finite. Then serving: an int8 corpus row-sharded over the
mesh with per-query blends (B2 q8 once a shard on the card), an int8 IVF
index and an IVF-PQ index cluster-sharded over it, a product-quantized
corpus (B5 once a shard on the card) and a binary-sketch corpus, each
merged from the shards' ``[Q, k]`` winners; then query data parallelism
(``CLIPRetrieval(shard_queries=True)``, 11 queries: the pad path). Each
sharded result is held to the same scan on one shard (the IVF probes at
nprobe = nlist to the exact scan), and one line a section is printed. The
mesh is the visible cards repeated to ``--devices`` positions (one card:
``[cuda:0] * n``), or ``cpu`` repeated with ``--device=cpu``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from ..ops import binary_sketch as B
from ..ops import pq as PQ
from ..ops import similarity as S
from ..parallel import MeshRuntime
from ..retrieval import ann as A
from ..utils.config import MeshConfig


def _agree(got, want, tag: str, tol: float = 1e-5) -> None:
    gv, gi = (t.float().cpu().numpy() for t in got)
    wv, wi = (t.float().cpu().numpy() for t in want)
    assert gv.shape == wv.shape and np.all(np.diff(gv, axis=1) <= 1e-6), tag
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol, err_msg=tag)
    differ = gi != wi
    assert (np.abs(gv - wv)[differ] <= tol).all(), f"{tag}: rows differ outside near ties"


def run_training(devices: List[torch.device], tag: str) -> List[str]:
    """The training sections; returns their lines."""
    import copy
    import math

    from ..models import clip as M
    from ..parallel import ep as EP
    from ..parallel import pp as PP
    from ..parallel import sp as SP
    from ..parallel.mesh import Mesh
    from ..train import trainer as T
    from ..utils.config import TrainConfig

    n = len(devices)
    lines = []
    arch = M.CLIPArch(16, 32, 2, 32, 16, 16, 128, 32, 2, 2, vision_heads=2)
    base = M.build_model("tiny", dtype=torch.float32, seed=0, arch=arch).to(devices[0])
    rng = np.random.default_rng(0)
    b = 2 * n
    ids = np.zeros((b, 16), np.int64)
    ids[:, 0], ids[:, 1], ids[:, 2] = 126, rng.integers(1, 120, b), 127
    batch = {"images": rng.standard_normal((b, 32, 32, 3)).astype(np.float32), "query_ids": ids,
             "target_ids": ids.copy()}
    cfg = TrainConfig(batch_size=b, epochs=1, global_negatives=True)

    def step(mesh_cfg: MeshConfig, use: List[torch.device], **kw) -> float:
        model = copy.deepcopy(base)
        rt = MeshRuntime.create(mesh_cfg, use)
        c = TrainConfig(**{**cfg.__dict__, **kw})
        if rt.fsdp or rt.mesh.shape[rt.model_axis] > 1:
            state = (T.init_state_fsdp if rt.fsdp else T.init_state_gspmd)(model, c, rt, 1)
            fn = T.make_train_step_gspmd(model, c, rt, state.layout)
        elif c.lora_rank:
            from ..train.lora import lora_init

            for p in model.parameters():
                p.requires_grad_(False)
            ad = {k: torch.nn.Parameter(v.to(devices[0])) for k, v in lora_init(
                dict(model.named_parameters()), c.lora_rank, "all", torch.Generator().manual_seed(0)).items()}
            state = T.TrainState(model, T.Optimizer(ad, c, 1), 0, None, ad)
            fn = T.make_train_step(model, c, ad, c.lora_alpha / c.lora_rank, rt=rt)
        else:
            state = T.TrainState(model, T.make_optimizer(c, 1, model))
            fn = T.make_train_step(model, c, rt=rt)
        _, metrics = fn(state, dict(batch))
        loss = float(metrics["loss"])
        assert math.isfinite(loss), f"non-finite loss {loss} ({mesh_cfg})"
        return loss

    loss = step(MeshConfig(data_parallel=n), devices)
    lines.append(f"{tag}: dp{n} train step ok, loss={loss:.4f}")
    loss_l = step(MeshConfig(data_parallel=n), devices, lora_rank=2, lora_alpha=4.0)
    lines.append(f"{tag}: lora dp{n} ok, loss={loss_l:.4f}")
    if n % 2 == 0:
        loss_t = step(MeshConfig(data_parallel=n // 2, model_parallel=2), devices)
        lines.append(f"{tag}: dp{n // 2} x tp2 GSPMD step ok, loss={loss_t:.4f}")

    def line_mesh(k: int, axis: str) -> Mesh:
        arr = np.empty(k, dtype=object)
        arr[:] = devices[:k]
        return Mesh(arr, (axis,))

    if n >= 4:
        arr = np.empty(4, dtype=object)
        arr[:] = devices[:4]
        pp_mesh = Mesh(arr.reshape(2, 2), ("data", "pipe"))
        blocks = [{k: v.detach().clone().requires_grad_() for k, v in blk.state_dict().items()}
                  for blk in base.text.transformer.resblocks]
        stacked = PP.stack_stages(blocks, 2)
        block = M.ResidualBlock(arch.text_width, arch.text_heads).to(devices[0])
        xs = torch.from_numpy(rng.standard_normal((4, 2, 16, 32)).astype(np.float32)).to(devices[0])
        val = (PP.pipeline_apply(lambda p, x: torch.func.functional_call(block, p, (x, True)), stacked, xs, pp_mesh,
                                 "pipe") ** 2).sum()
        val.backward()
        assert math.isfinite(val.item()) and all(torch.isfinite(t.grad).all() for t in blocks[0].values())
        lines.append(f"{tag}: dp2 x pp2 pipelined blocks ok, loss={val.item():.4f}")
        x_sp = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32)).to(devices[0]).requires_grad_()
        block_p = {k: v.detach() for k, v in base.text.transformer.resblocks[0].state_dict().items()}
        val_sp = (SP.sp_block_apply(block_p, x_sp, line_mesh(4, "seq"), heads=arch.text_heads, causal=True) ** 2).sum()
        val_sp.backward()
        assert math.isfinite(val_sp.item()) and torch.isfinite(x_sp.grad).all()
        lines.append(f"{tag}: sp4 ring-attention block ok, loss={val_sp.item():.4f}")
    loss_f = step(MeshConfig(data_parallel=n, fsdp=True), devices)
    lines.append(f"{tag}: fsdp{n} ZeRO-3 step ok, loss={loss_f:.4f}")
    if n % 2 == 0 and n >= 4:
        loss_d = step(MeshConfig(dcn_parallel=2, data_parallel=n // 2), devices)
        assert abs(loss_d - loss) < 1e-4, f"hybrid dcn loss {loss_d} != flat dp {loss}"
        lines.append(f"{tag}: dcn2 x dp{n // 2} hybrid DP ok, loss={loss_d:.4f} (== flat dp)")
    if n >= 4:
        moe = EP.init_moe_params(torch.Generator().manual_seed(1), arch.text_width, 2 * arch.text_width, 4)
        moe = {k: ({kk: vv.to(devices[0]).requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.to(devices[0]).requires_grad_()) for k, v in moe.items()}
        x_ep = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32)).to(devices[0])
        y, aux = EP.moe_apply(moe, x_ep, k=2, capacity=32, mesh=line_mesh(4, "expert"))
        val_ep = (y**2).sum() + 0.01 * aux
        val_ep.backward()
        assert math.isfinite(val_ep.item()) and torch.isfinite(moe["w_in"].grad).all()
        lines.append(f"{tag}: ep4 expert-sharded MoE ok, loss={val_ep.item():.4f}")
    return lines


def run(n_devices: int, device: str) -> List[str]:
    """Every section once; returns the printed lines."""
    cards = [torch.device("cpu")] if device == "cpu" else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rt = MeshRuntime.create(MeshConfig(data_parallel=n_devices), [cards[i % len(cards)] for i in range(n_devices)])
    mesh, dev = rt.mesh, rt.mesh.first_device
    tag = f"dryrun_multichip({n_devices} on {', '.join(str(d) for d in dict.fromkeys(rt.mesh.local_devices))})"
    lines = run_training([cards[i % len(cards)] for i in range(n_devices)], tag)
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((64 * n_devices, 16)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    rev = corpus[::-1].copy()
    put = lambda a, dt=None: torch.as_tensor(a).to(dev, dt)  # noqa: E731
    queries = put(corpus[:4])

    # the int8 corpus row-sharded, per-query blends in one call
    (iq, isc), (tq, tsc) = S.quantize_corpus_host(corpus), S.quantize_corpus_host(rev)
    args = [put(a) for a in (iq, isc, tq, tsc)]
    alpha = put(np.array([0.2, 0.5, 0.8, 1.0], np.float32))
    got = S.sharded_similarity_topk_q8(queries, *args, k=5, alpha=alpha, mesh=mesh)
    _agree(got, S.fused_similarity_topk_q8(queries, *args, k=5, alpha=alpha), "sharded int8")
    lines.append(f"{tag}: sharded int8-corpus top-k ok (per-query alphas), shape={tuple(got[0].shape)}")

    # int8 IVF and IVF-PQ, cluster-sharded; a full probe is the exact scan
    exact = S.fused_similarity_topk(queries, put(corpus), put(rev), k=5, alpha=0.5)
    for quantize, kw in (("int8", {}), ("pq", dict(pq_m=2))):
        index = A.build_ivf_index(corpus, rev, nlist=2 * n_devices, quantize=quantize, device=dev, **kw)
        iv, ii = A.sharded_ivf_search(queries, index, k=5, nprobe=index.nlist, mesh=mesh, alpha=0.5)
        one = A.ivf_search(queries, index, k=5, nprobe=index.nlist, alpha=0.5)
        _agree((iv, ii), one, f"sharded IVF {quantize}", tol=1e-4)
        assert int(ii.min()) >= 0
        if quantize == "int8":
            _agree((iv, ii), exact, "sharded IVF int8 at nprobe = nlist", tol=2e-2)
        lines.append(f"{tag}: sharded {'int8 IVF' if quantize == 'int8' else 'IVF-PQ'} probe ok, "
                     f"shape={tuple(iv.shape)}")

    # product-quantized corpus: codes row-shard, codebooks replicate
    cb_i = PQ.train_pq_codebooks(corpus, m=2, k=16, iters=4)
    cb_t = PQ.train_pq_codebooks(rev, m=2, k=16, iters=4)
    (ci, si), (ct, st) = PQ.pack_pq_host(corpus, cb_i), PQ.pack_pq_host(rev, cb_t)
    pargs = [put(a) for a in (ci, si, ct, st, cb_i, cb_t)]
    q_pq = queries.to(torch.bfloat16) if dev.type == "cuda" else queries
    got = PQ.sharded_pq_similarity_topk(q_pq, *pargs, k=5, alpha=0.5, mesh=mesh)
    _agree(got, PQ.pq_similarity_topk(q_pq, *pargs, k=5, alpha=0.5), "sharded pq")
    lines.append(f"{tag}: sharded pq top-k ok, shape={tuple(got[0].shape)}")

    # binary sketches: local Hamming scans, winners merged
    bimg = put(B.pack_sign_bits_host(corpus).view(np.int32))
    btxt = put(B.pack_sign_bits_host(rev).view(np.int32))
    got = B.sharded_hamming_topk(queries, bimg, btxt, dim=16, k=5, alpha=0.5, mesh=mesh)
    _agree(got, B.hamming_topk(queries, bimg, btxt, dim=16, k=5, alpha=0.5), "sharded binary", tol=0)
    lines.append(f"{tag}: sharded binary-sketch top-k ok, shape={tuple(got[0].shape)}")

    # query data parallelism: the batch splits over the mesh, corpus replicated
    from ..data.tokenizer import CLIPTokenizer
    from ..models import clip as M
    from ..retrieval.clip_retrieval import CLIPRetrieval
    from ..retrieval.embedding_store import EmbeddingStore

    tok = CLIPTokenizer([("h", "i")])
    arch = M.CLIPArch(16, 32, 1, 32, 16, 16, tok.vocab_size, 32, 2, 1, vision_heads=2)
    model = M.build_model("tiny", dtype=torch.float32, seed=1, device=dev, arch=arch)
    store = EmbeddingStore(image=corpus[:48], text=corpus[48:96], uuids=[f"u{i}" for i in range(48)])
    qdp = CLIPRetrieval(model, tok, store, device=dev, top_k=5, rt=rt, shard_queries=True, quantize_corpus="int8",
                        use_fused_encoder=False)
    plain = CLIPRetrieval(model, tok, store, device=dev, top_k=5, quantize_corpus="int8", use_fused_encoder=False)
    texts = ["hi hi", "hi"] * 5 + ["hi hi hi"]  # 11 queries: the pad path
    res = qdp.retrieval_batch(texts)
    assert len(res) == 11 and all(len(r) == 5 for r in res)
    assert [[x["uuid"] for x in r] for r in res] == [[x["uuid"] for x in r] for r in plain.retrieval_batch(texts)]
    lines.append(f"{tag}: query-DP int8 serving ok (queries sharded {rt.num_data}-way, corpus replicated)")
    for line in lines:
        print(line)
    return lines


def main(argv: Optional[List[str]] = None) -> List[str]:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=8, help="mesh positions (cards repeat to fill them)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device (pass --device=cpu for the plain versions)")
    return run(a.devices, a.device)


if __name__ == "__main__":
    main()
