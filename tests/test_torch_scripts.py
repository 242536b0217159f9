"""The port's profiling scripts (``scripts/{profile_serving,profile_vision,
vision_batch_sweep,profile_pq,profile_ivf,scale_bench}.py``) on the CPU.

Each runs through its ``main(argv)`` at a tiny size on ``--device=cpu``
(the kernels' plain versions, host clock: a check of the control flow and
of the JSON each writes, not a measurement) and emits one JSON line. The
recall helper equals the JAX script's own (``scripts/scale_bench.py``
``_recall_at``) and the exact ranking equals a numpy argsort; the PQ
encoder the scale bench runs on the device gives the host encoder's codes.
No script writes a tracked file by default.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.pq import pq_encode_host, train_pq_codebooks
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import (
    profile_ivf,
    profile_pq,
    profile_serving,
    profile_vision,
    scale_bench,
    timing,
    vision_batch_sweep,
)

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = {"profile_serving": profile_serving, "profile_vision": profile_vision,
           "vision_batch_sweep": vision_batch_sweep, "profile_pq": profile_pq, "profile_ivf": profile_ivf,
           "scale_bench": scale_bench}
TINY = TM.CLIPArch(64, 32, 2, 64, 16, 77, 600, 64, 1, 2)


@pytest.fixture(scope="module")
def jax_scale_bench():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))  # the script imports ``bench`` from the repo root
    spec = importlib.util.spec_from_file_location("_jax_scale_bench", REPO / "scripts/scale_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny_arch(monkeypatch):
    monkeypatch.setitem(TM.ARCHS, "tiny", TINY)
    return "tiny"


def _run(capsys, mod, argv, tmp_path):
    out = str(tmp_path / "out.json")
    payload = mod.main(argv + ["--device=cpu", f"--out={out}"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert json.loads(lines[-1]) == json.loads(json.dumps(payload)) == json.load(open(out))
    assert payload["device"] == "cpu" and payload["card"] is None
    return payload


def _host_only(t):
    """On the CPU a line carries the host clock only, never a device metric."""
    assert "host_ms" in t and t["host_ms"] > 0 and "device_ms" not in t and "event_ms" not in t


def test_profile_serving(capsys, tmp_path, tiny_arch):
    p = _run(capsys, profile_serving, [f"--model={tiny_arch}", "--corpus=300", "--batch=8", "--iters=2"], tmp_path)
    assert set(p["lines"]) == {"encode_only", "topk_only", "topk_q8c", "full", "encode_q8", "full_q8", "full_q8_q8c"}
    for line in p["lines"].values():
        _host_only(line)
        assert line["launches"] == {} and line["q_per_s"] > 0
    assert p["seq_bucket"] == 32  # 8-30 tokens between SOT and EOT


def test_serving_ids_are_the_benchmark_queries():
    ids = profile_serving.serving_ids(TINY, 64, np.random.default_rng(0))
    assert ids.shape[1] == 32
    eot = ids.argmax(1)
    assert (ids[:, 0] == TINY.vocab_size - 2).all() and (ids[np.arange(64), eot] == TINY.vocab_size - 1).all()
    assert ((eot >= 9) & (eot <= 31)).all()


def test_profile_vision(capsys, tmp_path, tiny_arch):
    p = _run(capsys, profile_vision, [f"--model={tiny_arch}", "--batch=3", "--iters=2"], tmp_path)
    assert p["seq_len"] == 5 and p["seq_pad"] == 16 and p["rows"] == 48
    assert set(p["blocks"]) == {"attn_q8", "attn_bf16", "mlp_q8", "mlp_bf16", "layer_q8"}
    for mode in ("bf16", "int8"):
        tower = p["towers"][mode]
        assert set(tower["lines"]) == {f"{mode} layers={n}" for n in (0, 1, 2)}
        _host_only(tower["full"])
        assert tower["images_per_s"] > 0


def test_profile_vision_layer_route_equals_the_pair():
    """The per-block lines time the blocks the tower's layer runs: B4b(B4a(x))
    equals the whole int8 layer (the plain versions, bit for bit)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as FE
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB

    model = TM.build_model("", dtype=torch.bfloat16, arch=TINY)
    q8 = FE.make_vision_plan(model, quantize="int8")["layers"][0]
    x = torch.randn((2 * 16, 64), generator=torch.Generator().manual_seed(0)).bfloat16()
    kw = dict(seq_len=16, heads=1, mask_len=5, causal=False)
    pair = FB.fused_mlp_block_q8(
        FB.fused_attention_block_q8(x, q8["ln1_scale"], q8["ln1_bias"], q8["wqkv"], q8["wqkv_s"], q8["bqkv"],
                                    q8["wo"], q8["wo_s"], q8["bo"], **kw),
        q8["ln2_scale"], q8["ln2_bias"], q8["w1"], q8["w1_s"], q8["b1"], q8["w2"], q8["w2_s"], q8["b2"])
    layer = FE._apply_layers(x, [q8], s_pad=16, heads=1, mask_len=5, causal=False)
    assert torch.equal(pair, layer)


def test_vision_batch_sweep(capsys, tmp_path):
    p = _run(capsys, vision_batch_sweep, ["--quick", "--bf16"], tmp_path)
    assert set(p["results"]) == {"int8@4", "int8@8", "bf16@4", "bf16@8"}
    for r in p["results"].values():
        _host_only(r["ms_per_batch"])
        assert len(r["runs_ms"]) == 2 and r["img_per_s"] > 0


def test_profile_pq(capsys, tmp_path):
    p = _run(capsys, profile_pq, ["--n=700", "--d=64", "--q=12", "--k=10", "--iters=2"], tmp_path)
    assert list(p["tiers"]) == ["bf16 exact", "int8", "int4", "pq m=8 decode", "pq m=8 adc"]
    tiers = p["tiers"]
    for t in tiers.values():
        _host_only(t)
    assert tiers["bf16 exact"]["recall@10"] >= 0.9 >= tiers["pq m=8 adc"]["recall@10"] > 0
    # the decode route and B5's plain version rank the same rows
    assert tiers["pq m=8 decode"]["recall@10"] == pytest.approx(tiers["pq m=8 adc"]["recall@10"], abs=0.05)
    assert [t["bytes_per_row_per_tower"] for t in tiers.values()] == [128, 68, 36, 12, 12]


def test_profile_ivf(capsys, tmp_path):
    p = _run(capsys, profile_ivf, ["--n=1500", "--d=32", "--batch=4", "--nlist=16", "--nprobe=2", "--repeats=2"],
             tmp_path)
    assert list(p["lines"]) == ["brute int8", "ivf int8 nprobe=2", "ivf int8 nprobe=8", "ivf pq nprobe=2"]
    assert set(p["builds"]) == {"int8", "pq"} and all(0 <= b["spill"] <= 1 for b in p["builds"].values())
    assert all(line["launches"] == {} for line in p["lines"].values())
    assert p["lines"]["ivf int8 nprobe=8"]["recall@10"] >= p["lines"]["ivf int8 nprobe=2"]["recall@10"]


def test_scale_bench(capsys, tmp_path):
    p = _run(capsys, scale_bench, ["--rows=2500", "--dim=64", "--batch=16", "--iters=2", "--exact",
                                   "--ivf-rows=1500"], tmp_path)
    assert list(p["tiers"]) == ["int8", "int4", "pq", "bf16", "ivf-int8@1k", "ivf-int4@1k", "ivf-pq@1k"]
    assert p["failed_tiers"] == {}
    assert p["tiers"]["bf16"]["recall@10"] >= 0.95 and p["tiers"]["int8"]["recall@10"] >= 0.9
    for t in p["tiers"].values():
        _host_only(t)


def test_scale_bench_empty_out_writes_nothing(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p = scale_bench.main(["--rows=800", "--dim=32", "--batch=8", "--iters=1", "--device=cpu", "--out="])
    assert list(p["tiers"]) == ["int8", "int4", "pq"] and list(tmp_path.iterdir()) == []
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(json.dumps(p))


def test_recall_helper_equals_the_jax_scripts(jax_scale_bench):
    rng = np.random.default_rng(4)
    for _ in range(5):
        exact = np.stack([rng.permutation(50)[:20] for _ in range(9)])
        ids = np.where(rng.random(exact.shape) < 0.6, exact, rng.integers(0, 50, exact.shape))
        for k in (1, 5, 10):
            assert scale_bench.recall_at(ids, exact, k) == jax_scale_bench._recall_at(ids, exact, k)


def test_exact_topk_equals_argsort():
    rng = np.random.default_rng(6)
    img, txt = (rng.standard_normal((3000, 48)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((7, 48)).astype(np.float32)
    got = scale_bench.exact_topk(q, img, txt, 0.3, 25, torch.device("cpu"), chunk=700)
    s = 0.3 * (q.astype(np.float64) @ img.T) + 0.7 * (q.astype(np.float64) @ txt.T)
    np.testing.assert_array_equal(got, np.argsort(-s, axis=1)[:, :25])


def test_pq_encode_gives_the_host_codes():
    rng = np.random.default_rng(8)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    rows[5] = 0.0  # a zero row packs to scale 0
    cb = train_pq_codebooks(rows, m=8)
    codes, scale = scale_bench.pq_encode(torch.from_numpy(rows), cb, chunk=1000)
    want_codes, want_scale = pq_encode_host(rows, cb)
    np.testing.assert_allclose(scale.numpy(), want_scale, rtol=1e-6)
    assert scale[5].item() == 0.0
    assert np.mean(codes.numpy() == want_codes) > 0.999  # f32 products in another order may flip a near tie


def test_default_outputs_are_never_tracked_files():
    tracked = set(subprocess.run(["git", "ls-files"], cwd=REPO, capture_output=True, text=True,
                                 check=True).stdout.splitlines())
    for name, mod in SCRIPTS.items():
        rel = Path(mod.DEFAULT_OUT).resolve().relative_to(REPO)
        assert rel.parts[0] == "chiprun_out", (name, rel)
        assert str(rel) not in tracked and rel.name not in tracked, (name, rel)
    ignored = subprocess.run(["git", "check-ignore", "-q", "chiprun_out/x.json"], cwd=REPO)
    assert ignored.returncode == 0, "chiprun_out/ must stay in .gitignore"
