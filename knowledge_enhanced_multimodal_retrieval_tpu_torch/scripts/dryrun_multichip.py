"""Dry run of sharded serving over an n-device mesh.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.dryrun_multichip \
        [--devices 8] [--device cuda|cpu]

The port's counterpart of the serving sections of the JAX package's
``__graft_entry__.dryrun_multichip``: an int8 corpus row-sharded over the
mesh with per-query blends (B2 q8 once a shard on the card), an int8 IVF
index and an IVF-PQ index cluster-sharded over it, a product-quantized
corpus (B5 once a shard on the card) and a binary-sketch corpus, each
merged from the shards' ``[Q, k]`` winners; then query data parallelism
(``CLIPRetrieval(shard_queries=True)``, 11 queries: the pad path). Each
sharded result is held to the same scan on one shard (the IVF probes at
nprobe = nlist to the exact scan), and one line a section is printed. The
mesh is the visible cards repeated to ``--devices`` positions (one card:
``[cuda:0] * n``), or ``cpu`` repeated with ``--device=cpu``. The training
sections wait for ROADMAP A5 (b).
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


def run(n_devices: int, device: str) -> List[str]:
    """Every section once; returns the printed lines."""
    cards = [torch.device("cpu")] if device == "cpu" else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    rt = MeshRuntime.create(MeshConfig(data_parallel=n_devices), [cards[i % len(cards)] for i in range(n_devices)])
    mesh, dev = rt.mesh, rt.mesh.first_device
    tag = f"dryrun_multichip({n_devices} on {', '.join(str(d) for d in dict.fromkeys(rt.mesh.local_devices))})"
    lines = []
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
