"""The port's own copies of the host modules, each held to its original.

The port imports nothing of the JAX package, so it carries copies of
``utils.config``, ``utils.logging_utils``, ``native.*`` and ``knowledge.*``.
Each copy gets the same inputs as its original here and must give the same
answers. The native engines build with ``g++`` into the port's ``_build/``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from knowledge_enhanced_multimodal_retrieval_tpu import knowledge as JK
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.native import bpe_wrapper as JBpe
from knowledge_enhanced_multimodal_retrieval_tpu.native import build as JBuild
from knowledge_enhanced_multimodal_retrieval_tpu.native import image_wrapper as JImage
from knowledge_enhanced_multimodal_retrieval_tpu.native import rerank_wrapper as JRerank
from knowledge_enhanced_multimodal_retrieval_tpu.utils import config as JC
from knowledge_enhanced_multimodal_retrieval_tpu.utils import logging_utils as JLog
from knowledge_enhanced_multimodal_retrieval_tpu_torch import knowledge as TK
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.preprocess import CLIP_MEAN, CLIP_STD
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.native import bpe_wrapper as TBpe
from knowledge_enhanced_multimodal_retrieval_tpu_torch.native import build as TBuild
from knowledge_enhanced_multimodal_retrieval_tpu_torch.native import image_wrapper as TImage
from knowledge_enhanced_multimodal_retrieval_tpu_torch.native import rerank_wrapper as TRerank
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.dispatch import BUILD_DIR
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import config as TC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import logging_utils as TLog

# ---------------------------------------------------------------------------
# utils.config
# ---------------------------------------------------------------------------

_ARGVS = {
    "defaults": [],
    "serve": ["--model.name=ViT-L/14", "--eval.encoder=int8", "--eval.quantize_corpus=int4", "--eval.rerank_factor=8",
              "--eval.ann=ivf", "--eval.ann_nprobe=8", "--fusion.alpha=0.6", "--fusion.beta=0.4"],
    "precompute": ["--model.name=ViT-L/14@336px", "--data.dataset=synthetic:32", "--data.image_size=336",
                   "--eval.batch_size=256", "--eval.encoder=fast"],
    "train": ["--train.epochs=3", "--train.lr=1e-5", "--mesh.data_parallel=4", "--model.dtype=float32"],
    "bools": ["--eval.rerank=true", "--eval.mmap_store=1", "--train.resume=false"],
}


@pytest.mark.parametrize("case", sorted(_ARGVS))
def test_config_from_argv_equals_the_original(case):
    want, got = JC.config_from_argv(_ARGVS[case]), TC.config_from_argv(_ARGVS[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(TC.EvalConfig)] == [f.name for f in dataclasses.fields(JC.EvalConfig)]


def test_config_file_and_roundtrip(tmp_path):
    path = str(tmp_path / "cfg.json")
    JC.save_json(JC.config_from_argv(["--eval.pq_m=96", "--train.epochs=2"]), path)
    want = JC.config_from_argv(["--config", path, "--fusion.alpha_clip=0.25"])
    got = TC.config_from_argv(["--config", path, "--fusion.alpha_clip=0.25"])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    out = str(tmp_path / "out.json")
    TC.save_json(got, out)
    assert dataclasses.asdict(JC.load_json(JC.Config, out)) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [["--train.no_such_key=1"], ["--nosection.x=1"], ["--eval.encoder.deep=1"]])
def test_config_bad_key_raises_the_same_keyerror(argv):
    with pytest.raises(KeyError) as want:
        JC.config_from_argv(argv)
    with pytest.raises(KeyError) as got:
        TC.config_from_argv(argv)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("encoder", ["flax", "fast", "int8", "bogus"])
def test_resolve_encoder_equals_the_original(encoder):
    try:
        want = JC.resolve_encoder(encoder)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TC.resolve_encoder(encoder)
        assert str(got.value) == str(e)
        return
    assert TC.resolve_encoder(encoder) == want


@pytest.mark.parametrize("value", ["", "none", "int8", "int4", "pq", "binary", "true", "bogus"])
def test_resolve_quantize_corpus_equals_the_original(value):
    try:
        want = JC.resolve_quantize_corpus(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TC.resolve_quantize_corpus(value)
        assert str(got.value) == str(e)
        return
    assert TC.resolve_quantize_corpus(value) == want


def test_endpoints_and_fusion_defaults(monkeypatch):
    monkeypatch.setenv("SPARQL_ENDPOINT", "http://localhost:9/sparql")
    assert dataclasses.asdict(TC.FusionConfig()) == dataclasses.asdict(JC.FusionConfig())
    assert dataclasses.asdict(TC.Endpoints.from_env()) == dataclasses.asdict(JC.Endpoints.from_env())


def test_logging_utils_copy(tmp_path):
    assert TLog.is_coordinator() is True  # one process, no process group
    metrics = {"loss": np.float32(0.5), "hist": np.arange(3), "nested": {"k": [np.int64(2)]}}
    assert TLog._jsonable(metrics) == JLog._jsonable(metrics)
    TLog.MetricsWriter(str(tmp_path), "run").log(1, metrics)
    line = json.loads((tmp_path / "run_metrics.jsonl").read_text())
    assert line == {"step": 1, "loss": 0.5, "hist": [0, 1, 2], "nested": {"k": [2]}}
    logger = TLog.setup_logger("kemr_torch.test", console=False)
    assert logger.name == "kemr_torch.test" and not logger.propagate


# ---------------------------------------------------------------------------
# native.* (g++ at first use, into the port's _build/)
# ---------------------------------------------------------------------------

MERGES = [("l", "o</w>"), ("h", "e"), ("he", "l"), ("hel", "lo</w>"), ("c", "a"), ("ca", "t</w>")]


def _needs(name):
    if not (JBuild.native_available(name) and TBuild.native_available(name)):
        pytest.skip("no g++ toolchain for the native engines")


def test_native_builds_land_in_the_ports_build_dir():
    _needs("bpe")
    assert os.path.samefile(TBuild._build_dir(), BUILD_DIR)
    assert os.path.exists(os.path.join(BUILD_DIR, "libbpe.so"))
    assert not os.path.samefile(TBuild._build_dir(), JBuild._build_dir())
    for name in ("bpe", "image", "rerank"):
        with open(os.path.join(TBuild._SRC_DIR, f"{name}.cpp")) as f:
            assert f.read().strip(), name  # the port carries its own sources


@pytest.mark.parametrize("text", ["hello cat", "hellocat hhee xyz", "Hello,   CAT!", "", "h " * 40])
def test_bpe_ids_equal_the_original(text):
    _needs("bpe")
    want = JTok(MERGES, use_native=True)
    got = TTok(MERGES, use_native=True)
    assert got._native is not None and type(got._native).__module__ == TBpe.__name__
    assert type(want._native).__module__ == JBpe.__name__
    np.testing.assert_array_equal(got([text], context_length=16), want([text], context_length=16))
    for word in text.split():
        assert got.bpe(word.lower()) == want.bpe(word.lower())


@pytest.mark.parametrize("mode", ["openai", "hf"])
def test_clip_preprocess_native_pixels_equal_the_original(rng, mode):
    _needs("image")
    for h, w in [(480, 640), (100, 300), (224, 224), (37, 500)]:
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = JImage.clip_preprocess_native(arr, 224, mode, CLIP_MEAN, CLIP_STD)
        got = TImage.clip_preprocess_native(arr, 224, mode, CLIP_MEAN, CLIP_STD)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TImage.resize_bicubic_u8(arr, 64, 80), JImage.resize_bicubic_u8(arr, 64, 80))


@pytest.mark.parametrize("per_query_alpha", [False, True])
def test_rerank_scores_native_equal_the_original(rng, per_query_alpha):
    _needs("rerank")
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    queries, image, text = norm(rng.standard_normal((9, 48))), norm(rng.standard_normal((200, 48))), norm(rng.standard_normal((200, 48)))
    idx = rng.integers(0, 200, (9, 12)).astype(np.int32)
    idx[0, :3] = -1  # ann sentinels
    idx[1, 0] = 205  # out of range: -inf
    alpha = rng.uniform(0, 1, 9).astype(np.float32) if per_query_alpha else 0.5
    want = JRerank.rerank_scores_native(queries, image, text, idx, alpha)
    got = TRerank.rerank_scores_native(queries, image, text, idx, alpha)
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[0, :3]).all() and np.isneginf(got[1, 0])


# ---------------------------------------------------------------------------
# knowledge.*
# ---------------------------------------------------------------------------

RDF_TYPE = "http://www.w3.org/1999/02/22-rdf-syntax-ns#type"
RDFS_LABEL = "http://www.w3.org/2000/01/rdf-schema#label"
CRM = "http://www.cidoc-crm.org/cidoc-crm"
CH = "https://example.org/ch"
DA = f"{CH}/DigitalArtefact"
P62 = f"{CRM}/P62_depicts"
P43 = f"{CRM}/P43_has_dimension"
P90 = f"{CRM}/P90_has_value"
E54 = f"{CRM}/E54_Dimension"


def _graph(K):
    """A small Cultural-Heritage graph built with package ``K``'s types."""
    store = K.TripleStore()
    for uuid, label, depicted, height in [
        ("uuid-000", "madonna and child", "mary", 50), ("uuid-001", "blue temple", None, 80),
        ("uuid-002", "madonna della seggiola", "mary", 110), ("uuid-003", "portrait of a man", "leonardo", 80),
    ]:
        art = f"{CH}/artefact/{uuid}"
        store.add(art, RDF_TYPE, K.URI(DA))
        store.add(art, RDFS_LABEL, K.Literal(label, lang="en"))
        if depicted:
            store.add(art, P62, K.URI(f"{CH}/entity/{depicted}"))
        dim = f"{CH}/dim/{uuid}"
        store.add(art, P43, K.URI(dim))
        store.add(dim, RDF_TYPE, K.URI(E54))
        store.add(dim, P90, K.Literal(str(height), "http://www.w3.org/2001/XMLSchema#integer"))
    store.add(f"{CH}/entity/mary", RDFS_LABEL, K.Literal("madonna", lang="en"))
    store.add(f"{CH}/entity/mary", RDF_TYPE, K.URI(f"{CH}/Person"))
    store.add(f"{CH}/entity/leonardo", RDFS_LABEL, K.Literal("leonardo da vinci"))
    store.add(f"{CH}/entity/leonardo", RDF_TYPE, K.URI(f"{CH}/Person"))
    return store


def _doc(K, label):
    return {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {
            "s": "DigitalArtefact", "p": P62, "o": "Entity_1", "sType": [DA], "oType": [],
            "values": [{"label": label, "rdfTerm": {"type": "uri", "value": K.PLACEHOLDER}}],
        }}],
    }


@pytest.mark.parametrize("label", ["madonna", "leonardo da vinci", "zzz-no-such-entity"])
def test_text2sparql_pipeline_equals_the_original(label):
    """Fake LLM + LocalKGSparqlClient: equal SPARQL text, equal hits."""
    out = {}
    for name, K in (("jax", JK), ("port", TK)):
        assert K.PLACEHOLDER == JK.PLACEHOLDER
        client = K.LocalKGSparqlClient(_graph(K))
        _, sparql = K.Text2JsonToSparqlPipeline(client).process_json_to_sparql(_doc(K, label))
        llm = K.FakeLLMClient({"q": "```json\n" + json.dumps(_doc(K, label)) + "\n```"})
        hits = K.Text2SparqlRetrieval(llm, K.LocalKGSparqlClient(_graph(K)), raise_errors=True).retrieval("q")
        out[name] = (sparql, sorted(hits), K.execute(_graph(K), sparql))
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"madonna": ["uuid-000", "uuid-002"], "leonardo da vinci": ["uuid-003"]}.get(
        label, ["uuid-000", "uuid-001", "uuid-002", "uuid-003"])


def test_convert_and_engine_equal_the_original():
    doc = {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {"s": "DigitalArtefact", "p": P43, "o": "Dimension_1", "sType": [DA], "oType": [E54]},
                      "children": [{"line": {"s": "Dimension_1", "p": P90, "o": "Value_1", "sType": [E54], "oType": [],
                                             "values": [{"label": "x", "rdfTerm": {"type": "literal", "value": "80",
                                                         "datatype": "http://www.w3.org/2001/XMLSchema#integer"}}]}}]}],
    }
    want, got = JK.convert(doc), TK.convert(doc)
    assert got == want
    assert TK.execute(_graph(TK), got) == JK.execute(_graph(JK), want)
    assert TK.strip_json_fences("```json\n{}\n```") == JK.strip_json_fences("```json\n{}\n```")
    for value in ("80", "3.5", "2020-01-01", "plain"):
        assert TK.infer_datatype(value) == JK.infer_datatype(value)
    with pytest.raises(TK.SparqlSyntaxError):
        TK.parse_query("SELECT ?a WHERE { ?a")


def test_fake_clients_and_circuit_wrappers_equal_the_original():
    for K in (JK, TK):
        fake = K.FakeKGSparqlClient(entities={}, artefacts=[f"{CH}/artefact/uuid-007"])
        t2s = K.Text2SparqlRetrieval(K.FakeLLMClient({}, default=json.dumps(_doc(K, "x"))), fake)
        wrapped = K.CachedRetrieval(K.CircuitBreakerRetrieval(t2s))
        assert wrapped.retrieval("anything") == ["uuid-007"]
        assert wrapped.retrieval("anything") == ["uuid-007"]  # served from the cache
    assert set(TK.__dict__) >= {n for n in JK.__dict__ if not n.startswith("_")}


# ---------------------------------------------------------------------------
# json2sparql: the port's repaired sanitizers
# ---------------------------------------------------------------------------

_HOSTILE_NAMES = ["1abc", "中文", "a.b", "a-b", "a b", "_x", "a__b", "9", "?", "v__"]


def _hostile_doc(subject, obj, predicate):
    return {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": subject}],
        "branches": [{"line": {"s": subject, "p": predicate, "o": obj, "sType": [DA], "oType": []}}],
    }


@pytest.mark.parametrize("name", _HOSTILE_NAMES)
def test_hostile_names_parse_and_run_in_the_port(name):
    """The names that the original's sanitizers let through (digit-first,
    non-ASCII, ``=`` at the start of a predicate IRI) now give SPARQL that
    the port's own parser reads and runs."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.knowledge.json2sparql import _safe_var

    var = _safe_var(name)
    assert var.isascii() and var[0].isalpha() and all(c.isalnum() or c == "_" for c in var)
    for predicate in (P62, "=evil", "<=evil>", "=" + P62):
        sparql = TK.convert(_hostile_doc(name, "Entity_1", predicate))
        TK.parse_query(sparql)
        rows = TK.execute(_graph(TK), sparql)["results"]["bindings"]
        assert (len(rows) == 3) if predicate == P62 else rows == []  # three artefacts depict an entity


def test_safe_var_keeps_distinct_names_distinct():
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.knowledge.json2sparql import _escape_uri, _safe_var

    names = _HOSTILE_NAMES + ["", "DigitalArtefact", "Entity_1", "a_b", "x", "v", "v1abc"]
    assert len({_safe_var(n) for n in names}) == len(names)
    assert _safe_var("a.b") == _safe_var("a.b") != _safe_var("a-b")
    for clean in ("DigitalArtefact", "Entity_1", "Dimension_1", "X_1"):
        assert _safe_var(clean) == clean  # clean names are kept, as the original keeps them
    assert _escape_uri("=evil") == "%3Devil" and _escape_uri(P62) == P62
    sparql = TK.convert(_hostile_doc("a.b", "a-b", P62))
    assert "?a_b__612e62" in sparql and "?a_b__612d62" in sparql


# ---------------------------------------------------------------------------
# utils.data_utils and utils.profiling
# ---------------------------------------------------------------------------


def test_data_utils_copy(tmp_path):
    from knowledge_enhanced_multimodal_retrieval_tpu.utils import data_utils as JD
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import data_utils as TD

    types = {f"u{i}": ["painting", "coin", "vase", "rare"][min(i % 7, 3)] for i in range(60)}
    assert TD.stratified_splits(types) == JD.stratified_splits(types)
    assert TD.stratified_splits({"a": "x", "b": "y"}) == JD.stratified_splits({"a": "x", "b": "y"})
    uuids = list(types)[:10]
    assert TD.get_text_variant_for_batch(uuids, 3) == JD.get_text_variant_for_batch(uuids, 3)
    out = str(tmp_path / "splits" / "s.json")
    TD.save_splits_to_json(["a"], ["b"], ["c", "d"], out)
    assert JD.load_splits_from_json(out) == TD.load_splits_from_json(out) == (["a"], ["b"], ["c", "d"])


def test_profiling_counterparts(tmp_path):
    import torch

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import profiling as P

    assert not P.enabled()
    with P.trace(str(tmp_path / "prof")):
        assert P.enabled()
        with P.annotate("kemr-region"), P.span("outer"):
            P.count("things", 3)
            torch.ones(8).sum()
    assert not P.enabled()  # the recorder is back off after the trace
    body = (tmp_path / "prof" / "trace.json").read_text()
    assert "kemr-region" in body and "kemr:outer" in body  # the span's range is in the Chrome trace
    snap = P.snapshot()
    assert snap["spans"]["outer"]["calls"] == 1 and snap["counters"] == {"things": 3}
    P.reset()
    assert P.snapshot() == {"spans": {}, "counters": {}}


# ---------------------------------------------------------------------------
# datagen (JAX tests/test_datagen.py's cases, over both packages)
# ---------------------------------------------------------------------------

from knowledge_enhanced_multimodal_retrieval_tpu.datagen import captioning as JCap  # noqa: E402
from knowledge_enhanced_multimodal_retrieval_tpu.datagen import metadata as JMeta  # noqa: E402
from knowledge_enhanced_multimodal_retrieval_tpu.datagen import texts as JTexts  # noqa: E402
from knowledge_enhanced_multimodal_retrieval_tpu_torch.datagen import captioning as TCap  # noqa: E402
from knowledge_enhanced_multimodal_retrieval_tpu_torch.datagen import metadata as TMeta  # noqa: E402
from knowledge_enhanced_multimodal_retrieval_tpu_torch.datagen import texts as TTexts  # noqa: E402

_DATAGEN = {"jax": (JCap, JMeta, JTexts), "port": (TCap, TMeta, TTexts)}
_COMBINE_CASES = [
    ("This is a painting, oil on canvas", "a painting of a dog"),
    ("Portrait of a lady", "a sculpture of a horse"),
    ("meta only", ""), ("", "content only"), ("", ""),
    ("This is a church, gothic style", "a church with a tall spire"),
    ("A Temples, carved", "temples by the sea"), ("A vase, red figure", "a vase with dancers"),
]


@pytest.mark.parametrize("metadata,content", _COMBINE_CASES)
def test_combine_descriptions_equals_the_original(metadata, content):
    assert TTexts.combine_descriptions(metadata, content) == JTexts.combine_descriptions(metadata, content)


@pytest.mark.parametrize("pkg", sorted(_DATAGEN))
def test_combine_lead_in_and_replacements(pkg):
    texts = _DATAGEN[pkg][2]
    out = texts.combine_descriptions("This is a painting, oil on canvas", "a painting of a dog")
    assert out.startswith("A painting of a dog") and "This is a painting" not in out and ", oil on canvas" in out
    assert texts.combine_descriptions("Portrait of a lady", "a sculpture of a horse") == (
        "A sculpture of a horse. Portrait of a lady")
    assert texts.combine_descriptions("meta only", "") == "Meta only"
    assert texts.combine_descriptions("", "content only") == "Content only"
    assert texts.combine_descriptions("", "") == ""
    assert "This is a church" not in texts.combine_descriptions("This is a church, gothic style",
                                                                "a church with a tall spire")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_select_content_equals_the_original(seed):
    import random

    descs = ["the church of the person x", "short", "a long valid caption one", "another valid caption two",
             "a third valid caption", "tiny"]
    want = JTexts.random_select_content(list(descs), random.Random(seed))
    got = TTexts.random_select_content(list(descs), random.Random(seed))
    assert got == want
    c1, c2 = got
    assert c1 != c2 and all("the church of the person" not in c and len(c) >= 10 for c in (c1, c2))
    assert TTexts.random_select_content(["bad"], random.Random(seed)) == ("", "")


def _hybrid_dirs(root):
    meta, content, images = root / "meta", root / "content", root / "img"
    for d in (meta, content, images):
        d.mkdir()
    for i in range(5):
        (meta / f"u{i}.json").write_text(json.dumps(
            {"metadata_descriptions": [f"This is a painting, from {1800 + i}", f"A painting, dated {1800 + i}"]}))
        (content / f"u{i}.json").write_text(json.dumps(
            {"content_descriptions": [f"a painting of scene {i}", "" if i == 3 else f"a view {i}"]}))
        (images / f"u{i}.jpg").write_bytes(b"x")
    (meta / "no-image.json").write_text(json.dumps({"metadata_descriptions": ["m"]}))
    return str(meta), str(content), str(images)


def test_build_hybrid_texts_equals_the_original(tmp_path):
    outs = {}
    for pkg in sorted(_DATAGEN):
        root = tmp_path / pkg
        root.mkdir()
        result = _DATAGEN[pkg][2].build_hybrid_texts(*_hybrid_dirs(root), str(root / "final"), seed=1)
        files = {f: json.load(open(root / "final" / f)) for f in sorted(os.listdir(root / "final"))}
        outs[pkg] = (result, files)
    assert outs["port"] == outs["jax"]
    assert sorted(outs["port"][0]["written"]) == [f"u{i}" for i in range(5)]


@pytest.mark.parametrize("pkg", sorted(_DATAGEN))
def test_captioning_pipeline_resume(tmp_path, pkg):
    cap_mod = _DATAGEN[pkg][0]
    cap = cap_mod.FakeCaptioner(num_captions=5)
    pipe = cap_mod.CaptioningPipeline(cap, str(tmp_path / "caps"), batch_size=2)
    uuids = [f"u{i}" for i in range(5)]
    r1 = pipe.run(uuids, [object()] * 5)
    assert sorted(r1["written"]) == sorted(uuids)
    assert len(json.load(open(tmp_path / "caps" / "u3.json"))["content_descriptions"]) == 5
    calls = cap.calls
    r2 = pipe.run(uuids, [object()] * 5)
    assert r2["written"] == [] and sorted(r2["skipped"]) == sorted(uuids) and cap.calls == calls
    with pytest.raises(ValueError):
        pipe.run(["a"], [])


def test_captioning_files_equal_the_original(tmp_path):
    files = {}
    for pkg in sorted(_DATAGEN):
        cap_mod = _DATAGEN[pkg][0]
        out = tmp_path / pkg
        cap_mod.CaptioningPipeline(cap_mod.FakeCaptioner(3), str(out), batch_size=3).run(
            [f"u{i}" for i in range(7)], [object()] * 7)
        files[pkg] = {f: (out / f).read_text() for f in sorted(os.listdir(out))}
    assert files["port"] == files["jax"]


def test_mesh_sharded_captioner_names_its_roadmap_item(tmp_path):
    """``MeshShardedCaptioner`` over ``[cpu] * 8`` against the JAX one over
    the 8 virtual devices (``tests/test_datagen.py``): 11 images (padded to
    16 by repeating the last), the same captions, and the unchanged
    pipeline drives it (resume)."""
    import jax
    import jax.numpy as jnp
    import torch

    from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime as JR
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime as TR

    C, L = 3, 4

    def j_caption(params, images):
        base = (images.mean(axis=(1, 2, 3))[:, None, None] * params["scale"]).astype(jnp.int32)
        return (base + jnp.arange(C, dtype=jnp.int32)[None, :, None] * 10 + jnp.arange(L, dtype=jnp.int32)) % 97

    def t_caption(params, images):
        rows.append(images.shape[0])
        base = (images.mean(dim=(1, 2, 3))[:, None, None] * params["scale"]).to(torch.int32)
        return (base + torch.arange(C, dtype=torch.int32)[None, :, None] * 10 + torch.arange(L, dtype=torch.int32)) % 97

    decode = lambda ids: " ".join(str(int(i)) for i in ids)  # noqa: E731
    rows = []
    rng = np.random.default_rng(0)
    images = [rng.random((8, 8, 3)).astype(np.float32) for _ in range(11)]
    want = JCap.MeshShardedCaptioner(j_caption, {"scale": jnp.float32(1000.0)}, decode, JR.create()).generate(images)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    cap = TCap.MeshShardedCaptioner(t_caption, {"scale": torch.tensor(1000.0)}, decode,
                                    TR.create(MeshConfig(data_parallel=8), [torch.device("cpu")] * 8))
    got = cap.generate(images)
    assert len(got) == 11 and got == want and rows == [2] * 8  # each shard captions its 2 rows
    pipe = TCap.CaptioningPipeline(cap, str(tmp_path / "caps"), batch_size=4)
    uuids = [f"m{i}" for i in range(11)]
    assert sorted(pipe.run(uuids, images)["written"]) == sorted(uuids)
    assert json.load(open(tmp_path / "caps" / "m7.json"))["content_descriptions"] == got[7]
    assert sorted(pipe.run(uuids, images)["skipped"]) == sorted(uuids)


def test_blip2_captioner_defaults_to_the_card():
    import inspect

    assert inspect.signature(TCap.Blip2Captioner).parameters["device"].default == "cuda"


_METADATA_CASES = [
    {"object_type": "Painting", "title": "Madonna and Child", "creator": "Unknown Master", "date": "1480",
     "material": "tempera on wood", "location": "Benaki Museum"},
    {"object_type": "vase"},
    {"title": "Untitled", "date": 1901},
    {},
]


@pytest.mark.parametrize("meta", _METADATA_CASES)
@pytest.mark.parametrize("num_variants", [3, 5, 7])
def test_metadata_descriptions_equal_the_original(meta, num_variants):
    got = TMeta.generate_metadata_descriptions(meta, num_variants=num_variants)
    assert got == JMeta.generate_metadata_descriptions(meta, num_variants=num_variants)
    assert len(got) == num_variants and all(v and "None" not in v for v in got)


def test_metadata_generation_cases():
    variants = TMeta.generate_metadata_descriptions(_METADATA_CASES[0], num_variants=5)
    assert len(set(variants)) > 1 and variants[0].startswith("This is a painting")
    assert any("1480" in v for v in variants) and any("Benaki Museum" in v for v in variants)
    assert variants == TMeta.generate_metadata_descriptions(_METADATA_CASES[0], num_variants=5)


def test_build_metadata_texts_equals_the_original(tmp_path):
    records = [{"uuid": "m1", "object_type": "icon", "creator": "A"}, {"uuid": "m2", "title": "T", "date": "1700"}]
    files = {}
    for pkg in sorted(_DATAGEN):
        out = tmp_path / pkg
        assert _DATAGEN[pkg][1].build_metadata_texts(records, str(out)) == ["m1", "m2"]
        files[pkg] = {f: json.load(open(out / f)) for f in sorted(os.listdir(out))}
    assert files["port"] == files["jax"] and len(files["port"]["m1.json"]["metadata_descriptions"]) == 5
