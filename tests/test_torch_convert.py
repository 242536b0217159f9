"""The port's checkpoint I/O (``models.convert``) held to the JAX package's.

One seeded flax tree (widths of 64 multiples: heads are ``width // 64`` in
both packages) is written in every layout the reference consumes — the
JAX package's flax ``.npz`` and OpenAI ``.pt``, an HF-layout state dict
from ``flax_to_hf`` and the state dict of a real ``transformers.CLIPModel``
holding the same weights — and each loads through the port's
``load_clip_state_dict`` / ``cli.common.build_model`` to bit-identical
parameters. The port's f32 CLIP on the CPU then agrees with the JAX
package's ``encode_image`` / ``encode_text`` within 1e-4 and with
``CLIPModel.get_*_features`` within 2e-4 (the JAX suite's bar). The port's
writers round-trip bit for bit and their files load in the JAX package.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models import convert as JC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import common
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import convert as TC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

transformers = pytest.importorskip("transformers")

ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128, vision_patch_size=16,
    context_length=16, vocab_size=101, text_width=128, text_heads=2, text_layers=2,
)
TARCH = TM.CLIPArch(64, 32, 2, 128, 16, 16, 101, 128, 2, 2)


def _inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    ids = np.zeros((b, 16), np.int64)
    for i in range(b):  # SOT, a few tokens, EOT = the largest id (argmax pooling)
        n = 3 + 2 * i
        ids[i, 0], ids[i, 1 : 1 + n], ids[i, 1 + n] = 99, rng.integers(1, 99, n), 100
    return images, ids


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert")
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(model, jax.random.PRNGKey(3)))
    files = {"flax_npz": str(root / "flax.npz"), "openai_pt": str(root / "openai.pt"),
             "hf_pt": str(root / "hf.pt"), "hf_model_pt": str(root / "hf_model.pt")}
    JC.save_params_npz(params, files["flax_npz"])
    JC.save_openai_pt(params, files["openai_pt"])
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in JC.flax_to_hf(params).items()},
               files["hf_pt"])
    hf = transformers.CLIPModel(JC.hf_clip_config(ARCH)).eval()
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in JC.flax_to_hf(params).items()}, strict=False)
    assert not unexpected and all(k.endswith("position_ids") for k in missing)
    torch.save(hf.state_dict(), files["hf_model_pt"])  # position_ids buffers included, where transformers keeps them
    return model, params, hf, files, root


def _tower(path):
    return TC.load_openai_state_dict(TC.load_clip_state_dict(path), dtype=torch.float32)


def _encode(tower, images, ids):
    with torch.no_grad():
        return (tower.encode_image(torch.from_numpy(images)).numpy(), tower.encode_text(torch.from_numpy(ids)).numpy())


def _assert_same_sd(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_formats_detected(world):
    _, params, hf, _, _ = world
    assert TC.detect_format(JC.flax_to_openai(params)) == "openai"
    assert TC.detect_format(TC.normalize_state_dict(hf.state_dict())) == "hf"
    with pytest.raises(ValueError, match="unrecognized"):
        TC.detect_format({"foo": np.zeros(1)})


@pytest.mark.parametrize("layout", ["flax_npz", "openai_pt", "hf_pt", "hf_model_pt"])
def test_every_layout_loads_to_one_model(world, layout):
    _, params, _, files, _ = world
    want = JC.flax_to_openai(params)
    _assert_same_sd(TC.load_clip_state_dict(files[layout]), want)
    assert TC.arch_from_state_dict(want) == TARCH
    # and through the CLI's --model.checkpoint: bit-identical parameters
    cfg = config_from_argv([f"--model.checkpoint={files[layout]}", "--model.dtype=float32"])
    _assert_same_sd(TC.openai_state_dict(common.build_model(cfg, torch.device("cpu"))), want)


@pytest.mark.parametrize("layout", ["flax_npz", "openai_pt", "hf_pt", "hf_model_pt"])
def test_embeddings_match_jax_and_transformers(world, layout):
    model, params, hf, files, _ = world
    images, ids = _inputs()
    img, txt = _encode(_tower(files[layout]), images, ids)
    j_img = np.asarray(JM.encode_image(model, params, jnp.asarray(images), normalize=False))
    j_txt = np.asarray(JM.encode_text(model, params, jnp.asarray(ids), normalize=False))
    np.testing.assert_allclose(img, j_img, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(txt, j_txt, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        h_img = hf.get_image_features(pixel_values=torch.from_numpy(images).permute(0, 3, 1, 2)).numpy()
        h_txt = hf.get_text_features(input_ids=torch.from_numpy(ids),
                                     attention_mask=torch.from_numpy((ids != 0).astype(np.int64))).numpy()
    np.testing.assert_allclose(img, h_img, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(txt, h_txt, rtol=2e-4, atol=2e-4)


def test_hf_and_openai_maps_are_inverse(world):
    _, params, _, _, _ = world
    oa = JC.flax_to_openai(params)
    hf = TC.openai_to_hf(oa)
    want = JC.flax_to_hf(params)
    assert hf.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(hf[k], want[k], err_msg=k)
    _assert_same_sd(TC.hf_to_openai(hf), oa)
    flat, jflat = TC.flatten_params(TC.openai_to_flax(oa)), JC.flatten_params(JC.openai_to_flax(oa))
    assert flat.keys() == jflat.keys()
    for k in jflat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)


@pytest.mark.parametrize("writer,ext", [("save_openai_pt", "pt"), ("save_hf_pt", "pt"), ("save_params_npz", "npz")])
def test_port_writers_roundtrip_and_load_in_jax(world, tmp_path, writer, ext):
    _, params, _, files, _ = world
    tower = _tower(files["openai_pt"])
    path = str(tmp_path / f"out.{ext}")
    getattr(TC, writer)(tower, path)
    _assert_same_sd(TC.load_clip_state_dict(path), TC.openai_state_dict(tower))
    got, want = JC.flatten_params(JC.load_clip_params(path)), JC.flatten_params(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32), err_msg=k)


def test_wrapped_layouts(world, tmp_path):
    _, params, hf, _, _ = world
    raw = hf.state_dict()
    base = TC.normalize_state_dict(raw)
    for i, wrap in enumerate((
        {"state_dict": raw},
        {"model_state_dict": raw, "epoch": 3},
        {"model": raw},
        {("module." + k): v for k, v in raw.items()},
    )):
        sd = TC.normalize_state_dict(wrap)
        assert sd.keys() == base.keys()
        path = str(tmp_path / f"wrapped{i}.pt")
        torch.save(wrap, path)
        _assert_same_sd(TC.load_clip_state_dict(path), JC.flax_to_openai(params))


def _scripted(sd):
    """A TorchScript archive whose state dict is ``sd`` plus OpenAI's
    scalar metadata buffers (the layout of OpenAI's ``clip`` downloads)."""
    root = nn.Module()
    for key, v in sd.items():
        node = root
        *path, leaf = key.split(".")
        for p in path:
            if not hasattr(node, p):
                node.add_module(p, nn.Module())
            node = getattr(node, p)
        node.register_parameter(leaf, nn.Parameter(torch.from_numpy(np.ascontiguousarray(v).copy())))
    for name, value in (("input_resolution", 32), ("context_length", 16), ("vocab_size", 101)):
        root.register_buffer(name, torch.tensor(value))
    return torch.jit.script(root)


@pytest.mark.parametrize("torch_load", ["dispatches", "raises"])
def test_torchscript_archive(world, tmp_path, monkeypatch, torch_load):
    """``torch.load`` either hands a TorchScript zip to ``torch.jit.load``
    (with a warning) or raises; both end in the same state dict."""
    _, params, _, _, _ = world
    want = JC.flax_to_openai(params)
    path = str(tmp_path / "scripted.pt")
    torch.jit.save(_scripted(want), path)
    if torch_load == "raises":
        def refuse(*a, **kw):
            raise RuntimeError("not a pickle")

        monkeypatch.setattr(torch, "load", refuse)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sd = TC.load_clip_state_dict(path)
    assert {"input_resolution", "context_length", "vocab_size"} <= sd.keys()
    _assert_same_sd({k: v for k, v in sd.items() if k in want}, want)
    images, ids = _inputs(1)
    tower = TC.load_openai_state_dict(sd, dtype=torch.float32)
    for a, b in zip(_encode(tower, images, ids), _encode(TC.load_openai_state_dict(want, dtype=torch.float32),
                                                         images, ids)):
        np.testing.assert_array_equal(a, b)


def test_export_hf_checkpoint_reloads_offline(world, tmp_path):
    _, _, hf, files, _ = world
    tower = _tower(files["flax_npz"])
    out = TC.export_hf_checkpoint(tower, TARCH, str(tmp_path / "hf_export"))
    reloaded = transformers.CLIPModel.from_pretrained(out, local_files_only=True).eval()
    images, ids = _inputs(2)
    with torch.no_grad():
        for fn, arg in ((lambda m, x: m.get_image_features(pixel_values=x), torch.from_numpy(images).permute(0, 3, 1, 2)),
                        (lambda m, x: m.get_text_features(input_ids=x), torch.from_numpy(ids))):
            np.testing.assert_array_equal(fn(reloaded, arg).numpy(), fn(hf, arg).numpy())
    _assert_same_sd(TC.hf_to_openai(TC.normalize_state_dict(reloaded.state_dict())), TC.openai_state_dict(tower))


def test_hf_config_pools_at_the_argmax_token():
    """``eos_token_id=2`` keeps transformers on the legacy argmax pooling
    both packages implement: an EOT that is not the first id-2 token and a
    sequence whose largest id sits before its end pool the same way."""
    cfg = TC.hf_clip_config(TARCH)
    assert cfg.text_config.eos_token_id == 2 and cfg.text_config.hidden_act == "quick_gelu"
    torch.manual_seed(0)
    hf = transformers.CLIPModel(cfg).eval()
    tower = TC.load_openai_state_dict(TC.hf_to_openai(TC.normalize_state_dict(hf.state_dict())), dtype=torch.float32)
    ids = np.zeros((2, 16), np.int64)
    ids[0, :6] = [99, 2, 7, 2, 5, 100]
    ids[1, :5] = [99, 100, 3, 4, 1]  # the largest id is not the last token
    with torch.no_grad():
        want = hf.get_text_features(input_ids=torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy((ids != 0).astype(np.int64))).numpy()
        got = tower.encode_text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cli_loads_a_port_written_flax_npz(world, tmp_path):
    """``--model.checkpoint`` of a flax ``.npz`` the port wrote itself."""
    _, params, _, files, _ = world
    path = str(tmp_path / "port_flax.npz")
    TC.save_params_npz(_tower(files["hf_pt"]), path)
    cfg = config_from_argv([f"--model.checkpoint={path}", "--model.dtype=float32"])
    _assert_same_sd(TC.openai_state_dict(common.build_model(cfg, torch.device("cpu"))), JC.flax_to_openai(params))
