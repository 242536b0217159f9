"""End-to-end HTTP daemon benchmark.

The port's counterpart of ``scripts/daemon_bench.py``: it drives the
deployable artifact, ``retrieval.http_server.RetrievalHTTPServer`` over the
int8 encoder, the int8 corpus and length-bucketed micro-batches, with N
concurrent HTTP clients (a text and image mix), and records q/s, p50 / p95 /
p99 end-to-end latency and the MicroBatcher's batch-size histograms. It
counts what a user of the daemon pays: HTTP framing, the MicroBatcher,
result slicing and JSON, as well as the search on the device. The clients
are threads of the same process, so they share its host cores with the
server.

    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.daemon_bench \\
        [--model ViT-L/14] [--corpus 43000] [--clients 32] [--requests-per-client 40] \\
        [--image-frac 0.1] [--device cuda] [--out result.json] [--quick]

Weights are seeded (``models.clip.build_model``), the corpus is random unit
rows made from seed 0, and the BPE table is a synthetic one (the repo holds
no CLIP vocabulary). ``--device`` defaults to ``cuda`` and never falls back:
``--device=cpu`` runs the kernels' plain versions. ``--quick`` is a tiny
architecture over 2,048 rows with 8 clients (a smoke run). The result is one
JSON line on standard output, also written to ``--out`` when it names a
file (never the JAX package's ``DAEMON_BENCH.json``).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import statistics
import subprocess
import threading
import time
import urllib.request

import numpy as np
import torch

from ..data.tokenizer import CLIPTokenizer
from ..models import clip as M
from ..ops import dispatch
from ..retrieval.clip_retrieval import CLIPRetrieval
from ..retrieval.embedding_store import EmbeddingStore
from ..retrieval.engine import RetrievalEngine
from ..retrieval.http_server import RetrievalHTTPServer
from ..cli.common import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]  # synthetic BPE table
QUICK_ARCH = M.CLIPArch(16, 32, 1, 32, 16, 16, 600, 32, 2, 1, vision_heads=2)


def _make_queries(rng, n):
    words = ["cat", "hello", "ca", "he", "painting", "madonna", "portrait",
             "landscape", "bronze", "statue", "manuscript", "tapestry"]
    return [" ".join(rng.choice(words, size=int(rng.integers(2, 10)))) for _ in range(n)]


def _device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (or the CPU)."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _pct(lats):
    if not lats:
        return {}
    ls = sorted(lats)
    q = lambda p: ls[min(len(ls) - 1, int(p * len(ls)))]  # noqa: E731
    return {"p50_ms": q(0.5) * 1e3, "p95_ms": q(0.95) * 1e3, "p99_ms": q(0.99) * 1e3,
            "mean_ms": statistics.mean(ls) * 1e3, "n": len(ls)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="ViT-L/14")
    p.add_argument("--corpus", type=int, default=43000)
    p.add_argument("--clients", type=int, default=32)
    p.add_argument("--requests-per-client", type=int, default=40)
    p.add_argument("--image-frac", type=float, default=0.1)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="", help="also write the JSON line to this file")
    p.add_argument("--quick", action="store_true", help="tiny arch smoke run")
    args = p.parse_args(argv)
    if args.out and os.path.abspath(args.out) == os.path.join(REPO, "DAEMON_BENCH.json"):
        raise ValueError("DAEMON_BENCH.json holds the JAX package's record; pass another --out")
    device = resolve_device(args.device)

    arch = None
    if args.quick:
        arch, args.corpus = QUICK_ARCH, 2048
        args.clients, args.requests_per_client = 8, 6
    rng = np.random.default_rng(0)
    print(f"building {'quick' if args.quick else args.model} + {args.corpus}-row store on {device} ...", flush=True)
    model = M.build_model(args.model, dtype=torch.bfloat16, seed=0, device=device, arch=arch)
    if device.type == "cuda":
        dispatch.library()  # build the kernels before the clock starts
    tok = CLIPTokenizer(MERGES)

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)

    d = model.arch.embed_dim
    store = EmbeddingStore(
        image=norm(rng.standard_normal((args.corpus, d))).astype(np.float32),
        text=norm(rng.standard_normal((args.corpus, d))).astype(np.float32),
        uuids=[f"uuid-{i:06d}" for i in range(args.corpus)],
    )
    # the production configuration: int8 encoder + int8 corpus, micro-batches
    # split by seq bucket; the layer kernels need 128-multiple widths, so the
    # quick arch rides the module towers
    fused_ok = model.arch.text_width % 128 == 0 and model.arch.vision_width % 128 == 0
    retriever = CLIPRetrieval(
        model, tok, store, device=device, top_k=args.k,
        use_fused_encoder=fused_ok, quantize="int8" if fused_ok else None, quantize_corpus="int8",
    )
    engine = RetrievalEngine(retriever, t2s_retriever=None)

    # micro-batches pad to powers of two, so the whole ladder up to
    # max_batch can occur under bursty load: run all of it before serving
    sizes, b = [], 1
    while b <= args.max_batch:
        sizes.append(b)
        b *= 2
    img_sizes = [s for s in sizes if s <= 64]  # the image batcher caps at 64
    print(f"warming buckets {sizes} (+image {img_sizes}) ...", flush=True)
    t0 = time.time()
    nprog = retriever.warmup(sizes, alpha=0.5)
    if args.image_frac > 0:
        nprog += retriever.warmup(img_sizes, alpha=0.5, image=True)
    print(f"  {nprog} searches in {time.time() - t0:.1f}s", flush=True)

    server = RetrievalHTTPServer(
        engine.retrieve_text_noknowledge_batch,
        host="127.0.0.1", port=0,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        default_n=args.k,
        image_batch_fn=engine.retrieve_image_batch,
        image_preprocess_fn=retriever.preprocess_images,
        length_bucket_fn=retriever.seq_bucket,
    )

    queries = _make_queries(rng, 512)
    s = model.arch.image_resolution
    # real PNG blobs: the server decodes and preprocesses on the request thread
    from PIL import Image

    img_blobs = []
    for _ in range(8):
        im = Image.fromarray(rng.integers(0, 255, (s, s, 3), dtype=np.uint8), "RGB")
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        img_blobs.append(base64.b64encode(buf.getvalue()).decode())

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
            return json.loads(r.read())

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    with server:
        port = server.address[1]
        print(f"daemon on :{port}; driving {args.clients} clients x {args.requests_per_client} requests "
              f"({args.image_frac:.0%} images) ...", flush=True)
        assert get("/healthz")["ok"]
        lat_text, lat_img, errors = [], [], []
        lock = threading.Lock()
        start_barrier = threading.Barrier(args.clients + 1)

        def client(cid):
            crng = np.random.default_rng(cid)
            start_barrier.wait()
            for _ in range(args.requests_per_client):
                is_img = crng.random() < args.image_frac
                t0 = time.perf_counter()
                try:
                    if is_img:
                        out = post("/search_image",
                                   {"image": img_blobs[int(crng.integers(0, len(img_blobs)))], "n": args.k})
                    else:
                        out = post("/search", {"query": queries[int(crng.integers(0, len(queries)))], "n": args.k})
                    dt = time.perf_counter() - t0
                    with lock:
                        (lat_img if is_img else lat_text).append(dt)
                        if not out["results"]:
                            errors.append("empty result")
                except Exception as e:  # noqa: BLE001
                    with lock:
                        errors.append(f"{type(e).__name__}: {e}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(args.clients)]
        for t in threads:
            t.start()
        start_barrier.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        stats = server.batcher.stats
        img_stats = server.image_batcher.stats if server.image_batcher is not None else {}

    total = len(lat_text) + len(lat_img)
    result = {
        "metric": f"HTTP daemon throughput ({'quick' if args.quick else args.model}, int8+bucketed, "
                  f"{args.clients} clients)",
        "value": total / wall,
        "unit": "requests/sec end-to-end",
        "detail": {
            "backend": device.type,
            "corpus_rows": args.corpus,
            "wall_s": wall,
            "requests_total": total,
            "errors": errors[:10],
            "error_count": len(errors),
            "text": _pct(lat_text),
            "image": _pct(lat_img),
            "text_batcher": stats,
            "image_batcher": img_stats,
            "note": f"device: {_device_line(device)}; torch {torch.__version__}; client threads share "
                    f"the host's {os.cpu_count()} cores with the server",
        },
    }
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
