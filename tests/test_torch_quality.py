"""The port's quality sweep, autotuner, their scripts and ``image_ops``, held
to the JAX package.

The sweep's rows over one seeded world: exact, int8, int4, pq, binary (and
their rerank, rotated, OPQ and Matryoshka rows) equal the JAX sweep's; the
IVF rows are compared by structure and a recall band, since a port-built
index clusters from another seed row than a JAX-built one.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.eval import autotune as JA
from knowledge_enhanced_multimodal_retrieval_tpu.eval import quality as JQ
from knowledge_enhanced_multimodal_retrieval_tpu.ops import image_ops as JI
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import autotune as TA
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import quality as TQ
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import image_ops as TI
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import autotune as t_autotune
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import quality_sweep as t_sweep


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    """Anisotropic towers (packing loses recall on them) and 16 queries.
    The width is a power of two and the sweeps blend at alpha 0.5: the
    binary proxies ``1 - (2 / d) * ham`` and their blend are then exact in
    f32 however products and sums are grouped (XLA may fuse them into one
    multiply-add, PyTorch does not), so the proxies' many ties break the
    same way in both packages."""
    rng = np.random.default_rng(11)
    d = 64
    spec = 2.0 ** (-np.arange(d) / 4.0)
    return tuple(_norm(rng.standard_normal((n, d)) * spec) for n in (320, 320, 16))


def _same_rows(got, want):
    assert [r["config"] for r in got] == [r["config"] for r in want]
    for g, w in zip(got, want):
        assert g["recall_at_k"] == pytest.approx(w["recall_at_k"], abs=1e-12), g["config"]
        assert g["top1_retained"] == pytest.approx(w["top1_retained"], abs=1e-12), g["config"]
        assert g["score_mae"] == pytest.approx(w["score_mae"], rel=1e-4, abs=1e-7), g["config"]


def test_sweep_rows_match_jax(world):
    image, text, q = world
    kw = dict(k=8, alpha=0.5, rerank_factor=3, truncate_dims=(32,), rotate=True, rotate_seed=2)
    got = TQ.quality_sweep(image, text, q, device="cpu", **kw)
    want = JQ.quality_sweep(image, text, q, **kw)
    _same_rows(got, want)
    by = {r["config"]: r for r in got}
    assert {"int8", "int4", "pq", "binary", "pq+opq", "int4+rot+rerank3x", "trunc32+rerank3x"} <= set(by)
    assert by["exact"] == {"config": "exact", "recall_at_k": 1.0, "top1_retained": 1.0, "score_mae": 0.0}
    assert TQ.format_table(got).splitlines()[0] == JQ.format_table(want).splitlines()[0]


def test_sweep_aniso_rows_match_jax(world):
    image, text, q = world
    got = TQ.quality_sweep(image, text, q, k=5, pq_aniso_t=0.2, device="cpu")
    want = JQ.quality_sweep(image, text, q, k=5, pq_aniso_t=0.2)
    _same_rows(got, want)
    assert "pq+aniso+rerank4x" in {r["config"] for r in got}


def test_sweep_ivf_rows_by_structure_and_band(world):
    image, text, q = world
    got = TQ.quality_sweep(image, text, q, k=8, nprobes=(3, 64), nlist=16, device="cpu")
    want = JQ.quality_sweep(image, text, q, k=8, nprobes=(3, 64), nlist=16)
    assert [r["config"] for r in got] == [r["config"] for r in want]
    by_t, by_j = ({r["config"]: r for r in rows if r["config"].startswith("ivf")} for rows in (got, want))
    assert list(by_t) == ["ivf-nprobe3/16", "ivf-nprobe16/16"]
    assert by_t["ivf-nprobe16/16"]["recall_at_k"] == by_j["ivf-nprobe16/16"]["recall_at_k"] == 1.0  # full probe
    assert abs(by_t["ivf-nprobe3/16"]["recall_at_k"] - by_j["ivf-nprobe3/16"]["recall_at_k"]) <= 0.15
    assert 0.0 < by_t["ivf-nprobe3/16"]["recall_at_k"] < 1.0


def test_recommend_config_matches_jax(world):
    image, text, q = world
    for kw in (dict(recall_target=0.95), dict(recall_target=0.9, rerank_ok=False), dict(recall_target=1.0)):
        got = TA.recommend_config(image, text, q, k=8, device="cpu", **kw)
        want = JA.recommend_config(image, text, q, k=8, **kw)
        for key in ("config", "kwargs", "serve_flags", "capacity_multiplier", "bytes_per_dim", "k", "recall_target"):
            assert got[key] == want[key], (kw, key)
        assert got["predicted_recall_at_k"] == pytest.approx(want["predicted_recall_at_k"])
        _same_rows(got["rows"], want["rows"])
    assert TA.serve_flags({"quantize_corpus": "pq", "rotate": "opq"}, 3) == \
        JA.serve_flags({"quantize_corpus": "pq", "rotate": "opq"}, 3)
    with pytest.raises(ValueError, match="recall_target"):
        TA.recommend_config(image, text, q, recall_target=1.5, device="cpu")


def _json_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_scripts_print_the_jax_scripts_json_line(capsys, monkeypatch):
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent

    def jax_script(name):
        spec = importlib.util.spec_from_file_location(f"jax_{name}", root / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    args = ["--synthetic", "256,32", "--queries", "12", "--k", "5"]
    out = t_sweep.main(args + ["--rotate", "--device=cpu"])
    got = _json_line(capsys)
    assert got == json.loads(json.dumps(out))
    monkeypatch.setattr(jax_script("quality_sweep"), "_force_cpu", lambda: None)
    jax_script("quality_sweep").main(args + ["--rotate"])
    want = _json_line(capsys)
    assert (got["k"], got["alpha"]) == (want["k"], want["alpha"])
    _same_rows(got["rows"], want["rows"])

    t_autotune.main(args + ["--recall-target", "0.9", "--device=cpu"])
    got = _json_line(capsys)
    jax_script("autotune").main(args + ["--recall-target", "0.9"])
    want = _json_line(capsys)
    assert set(got) == set(want)
    for key in ("config", "kwargs", "serve_flags", "capacity_multiplier"):
        assert got[key] == want[key], key
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            t_sweep.main(args)  # --device defaults to cuda and never falls back
    with pytest.raises(SystemExit):
        t_sweep.main(["--device=cpu"])  # needs --store or --synthetic


@pytest.mark.parametrize("shape,size", [((300, 400, 3), 224), ((64, 48, 3), 32), ((50, 37, 3), 224),
                                        ((17, 90, 3), 40), ((224, 300, 3), 224)],
                         ids=["down", "down-small", "up", "up-wide", "one-axis"])
def test_image_ops_match_jax(shape, size):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape).astype(np.uint8)
    want = np.asarray(JI.resize_shorter_side(jnp.asarray(img), size)) / 255.0
    got = TI.resize_shorter_side(torch.as_tensor(img), size).numpy() / 255.0
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    want_p = np.asarray(JI.preprocess_image(jnp.asarray(img), size=size))
    got_p = TI.preprocess_image(torch.as_tensor(img), size).numpy()
    assert got_p.shape == (size, size, 3)
    # the [0, 1] image before normalization, within 1e-4
    np.testing.assert_allclose(got_p * np.asarray(TI.CLIP_STD), want_p * np.asarray(JI.CLIP_STD), atol=1e-4, rtol=0)


def test_image_ops_crop_normalize_and_batch():
    rng = np.random.default_rng(0)
    img = rng.random((40, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(TI.center_crop(torch.as_tensor(img), 20).numpy(),
                                  np.asarray(JI.center_crop(jnp.asarray(img), 20)))
    np.testing.assert_array_equal(TI.center_crop(torch.as_tensor(img), 50).numpy(), img)  # larger than the image
    np.testing.assert_allclose(TI.normalize(torch.as_tensor(img)).numpy(), np.asarray(JI.normalize(jnp.asarray(img))),
                               rtol=1e-6)
    batch = rng.integers(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    got = TI.preprocess_batch(torch.as_tensor(batch), size=32).numpy()
    want = np.asarray(JI.preprocess_batch(jnp.asarray(batch), size=32))
    assert got.shape == want.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got * np.asarray(TI.CLIP_STD), want * np.asarray(JI.CLIP_STD), atol=1e-4)
    with pytest.raises(ValueError, match="resize method"):
        TI.resize(torch.as_tensor(img), (10, 10), method="lanczos9")
