"""Worker process of the port's two-process sharded-serving test.

Launched by ``tests/test_torch_multihost.py`` (not collected by pytest); it
imports torch and the port, never JAX. The processes start
``torch.distributed`` over gloo through ``parallel.mesh.runtime_init``
(torchrun's variables) and form one mesh of ``[cpu] * 4`` each (8 shards for two): the
int8 corpus stages sharded across the process boundary, each process
holding only its four shards, and searches run through
``retrieval.multihost.MultiHostSearch`` (rank 0 broadcasts, both scan their
shards, the winners gather). Then ``cli.serve --multihost`` end to end. The
parent compares rank 0's answers with the JAX package's single-host ones.

Usage: ``python mp_torch_serve_worker.py <rank> <world> <port> <dir>``; the
directory holds ``weights.npz`` (OpenAI layout), ``store.npz``, ``q.npy``
and ``bpe.txt.gz``, and receives ``serve_p<rank>.json``.
"""

import contextlib
import io
import json
import os
import sys


def main() -> None:
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      CLIP_BPE_PATH=os.path.join(out, "bpe.txt.gz"))
    import numpy as np
    import torch

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve as serve_mod
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as M
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import (
        load_clip_state_dict,
        load_openai_state_dict,
    )
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime, runtime_init
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.multihost import MultiHostSearch
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    backend = runtime_init()
    assert backend == "gloo" and torch.distributed.get_world_size() == world
    arch = M.CLIPArch(16, 32, 1, 32, 16, 16, 49408, 32, 2, 1, vision_heads=2)
    weights = os.path.join(out, "weights.npz")
    model = load_openai_state_dict(load_clip_state_dict(weights), dtype=torch.float32, arch=arch)
    store_path = os.path.join(out, "store.npz")
    store = EmbeddingStore.load(store_path)
    q = np.load(os.path.join(out, "q.npy"))

    rt = MeshRuntime.create(MeshConfig(), [torch.device("cpu")] * 4)  # four shards a process
    r = CLIPRetrieval(model, CLIPTokenizer.find_default(), store, device="cpu", top_k=8, use_fused_encoder=False,
                      rt=rt, shard_corpus=True, quantize_corpus="int8")
    shards = [g for g, _ in r.corpus_img.shards]
    assert r.corpus_img.n_shards == 4 * world and shards == list(range(4 * rank, 4 * rank + 4)), shards
    mh = MultiHostSearch(r, batch=4)
    report = {"world": torch.distributed.get_world_size(), "rank": rank, "backend": backend, "shards": shards}
    if mh.is_coordinator:
        got = mh.search_embeddings(q, alpha=0.6)  # 5 queries: two lockstep blocks
        mh.stop()
        mh.stop()  # idempotent
        report["got"] = [[x["uuid"] for x in row] for row in got]
        report["got_scores"] = [[x["score"] for x in row] for row in got]
    else:
        report["served"] = mh.serve()

    # the serve CLI end to end under --multihost (the process group is up:
    # its runtime_init is a no-op)
    M.ARCHS["tiny"] = arch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_mod.main([
            "--store", store_path, f"--model.checkpoint={weights}", "--model.name=tiny", "--model.dtype=float32",
            "--eval.encoder=flax", "--eval.shard_corpus=true", "--eval.quantize_corpus=int8",
            "--mesh.data_parallel=8", "--multihost", "--multihost-batch=4", "--query", "hello cat", "--device=cpu",
        ])
    if rank == 0:
        text = buf.getvalue()
        report["cli_got"] = [x["uuid"] for x in json.loads(text[text.index("{"):])["results"]]
    torch.distributed.destroy_process_group()
    with open(os.path.join(out, f"serve_p{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main()
