"""FSDP builds its parameters a unit at a time, as the JAX package's GSPMD does.

The JAX package cuts parameters and moments over the data axis and lets XLA
gather each layer's weights before its use (``parallel/fsdp.py``: ZeRO-3).
The port's GSPMD step (``parallel.fsdp.BlockGather``) builds a residual
block's parameters when its forward starts and releases them when it ends,
each leaf outside the blocks where it is read, and keeps none of them, nor a
cast of one, for the backward, which builds them again. Over a small CLIP
(two layers a tower) on ``[cpu] * 4`` at ``fsdp4`` and ``fsdp2xtp2``:

- (a) when the loss is reached no built parameter is alive
  (``ShardedParams.gauge``) and no cast of one (a ``TorchFunctionMode``
  records every ``Tensor.to`` of a built tensor);
- (b) the built bytes alive never exceed the largest unit: a block, or the
  largest leaf outside the blocks;
- remat, FLIP and GradCache under FSDP equal the data-parallel step with
  global negatives (loss 1e-5, parameters 2e-5: ``tests/test_fsdp.py``).
"""

import weakref

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as CM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig, TrainConfig
from tests.test_torch_dp_train import meshes, one_thread  # noqa: F401
from tests.test_torch_train import cfgs, port_model, world  # noqa: F401

# two layers a tower, a block (~50k parameters) larger than any leaf outside the blocks
ARCH = CM.CLIPArch(16, 32, 2, 64, 8, 16, 128, 64, 2, 2, vision_heads=2)
LAYOUTS = {"fsdp4": dict(data_parallel=4, fsdp=True),
           "fsdp2xtp2": dict(data_parallel=2, model_parallel=2, fsdp=True)}


class _CastProbe(TorchFunctionMode):
    """Weak references to every ``Tensor.to`` result of a built tensor."""

    def __init__(self, gauge):
        super().__init__()
        self.gauge, self.casts = gauge, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.to and out is not args[0] and any(r() is args[0] for r in self.gauge._alive.values()):
            self.casts.append(weakref.ref(out))
        return out


def _largest_unit(layout) -> int:
    """Bytes of the largest unit the step builds: a residual block's cut
    parameters, or one cut leaf outside the blocks."""
    units = {}
    for name, spec in layout.specs.items():
        if any(a is not None for a in spec):
            head, sep, rest = name.partition(".resblocks.")
            unit = head + sep + rest.split(".")[0] if sep else name
            units[unit] = units.get(unit, 0) + int(np.prod(layout.shapes[name])) * layout.dtypes[name].itemsize
    return max(units.values())


@pytest.mark.parametrize("remat", [False, True], ids=["", "remat"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fsdp_builds_one_unit_at_a_time(layout, dtype, remat):
    model = CM.build_model("tiny", dtype=dtype, seed=0, arch=ARCH, remat=remat)
    rt = MeshRuntime.create(MeshConfig(**LAYOUTS[layout]), [torch.device("cpu")] * 4)
    cfg = TrainConfig(batch_size=8, global_negatives=True, lr=1e-3)
    state = TT.init_state_gspmd(model, cfg, rt, 1)
    step = TT.make_train_step_gspmd(model, cfg, rt, state.layout)
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((8, 32, 32, 3)).astype(np.float32),
             "query_ids": rng.integers(1, 127, (8, 16)), "target_ids": rng.integers(1, 127, (8, 16))}
    gauge = state.layout.gauge
    probe = _CastProbe(gauge)
    at_loss = {}
    loss_fn = step.emb_loss

    def emb_loss(*embeddings, **kw):  # every tower's forward is done: what is kept is kept for the backward
        at_loss.update(built=gauge.bytes, casts=sum(r() is not None for r in probe.casts), cast_count=len(probe.casts))
        return loss_fn(*embeddings, **kw)

    step.emb_loss = emb_loss
    gauge.reset()
    with probe:
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert at_loss["built"] == 0, f"{at_loss['built']} bytes of built parameters kept for the backward"
    assert at_loss["casts"] == 0, f"{at_loss['casts']} casts of built parameters kept for the backward"
    if dtype == torch.bfloat16:
        assert at_loss["cast_count"] > 0  # the probe saw the projections' casts
    largest = _largest_unit(state.layout)
    assert 0 < gauge.peak <= largest, (gauge.peak, largest)
    assert gauge.bytes == 0


FSDP_VARIANTS = {
    "remat": dict(remat=True),
    "flip": dict(image_mask_ratio=0.5),
    "remat_flip": dict(remat=True, image_mask_ratio=0.5),
    "gradcache": dict(grad_cache_chunks=2),
}


@pytest.mark.parametrize("case", sorted(FSDP_VARIANTS))
def test_fsdp_variants_match_the_dp_step(world, tmp_path, case):
    """Remat (the recompute builds its block again), FLIP (the GSPMD step's
    one draw over the global batch, handed to the DP step too) and
    GradCache's chunked passes under FSDP4 against DP4 with global
    negatives: two steps, loss 1e-5, parameters 2e-5."""
    arch, params, _, tpipe, batches = world
    kw = dict(FSDP_VARIANTS[case])
    remat = kw.pop("remat", False)
    _, tcfg = cfgs(str(tmp_path), global_negatives=True, **kw)
    fs = TT.CLIPTrainer(port_model(arch, params, remat=remat), tpipe, None, tcfg, rt=meshes(4, fsdp=True)[1],
                        out_dir=str(tmp_path / "fsdp"))
    dp = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=meshes(4)[1], out_dir=str(tmp_path / "dp"))
    assert fs.state.layout is not None and dp.state.layout is None
    dp.train_step.keep_idx = fs.train_step.keep_idx
    for b in batches[:2]:
        fs.state, mf = fs.train_step(fs.state, fs._device_batch(b))
        dp.state, md = dp.train_step(dp.state, dp._device_batch(b))
        assert float(mf["loss"]) == pytest.approx(float(md["loss"]), abs=1e-5)
    got = fs.params()
    for name, p in dp.model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.detach().numpy(), rtol=0, atol=2e-5, err_msg=name)


def test_profile_parallel_runs_on_the_cpu(tmp_path):
    """``scripts/profile_parallel.py --quick`` over ``[cpu] * 4``: both
    layouts train, their losses agree, FSDP reports what it built at once,
    and ``--profile`` adds the FSDP step's operator table."""
    import json

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_parallel

    out = tmp_path / "pp.json"
    res = profile_parallel.main(["--quick", "--device=cpu", "--steps=1", "--profile", "--out", str(out)])
    dp, fsdp = res["layouts"]["dp"], res["layouts"]["fsdp"]
    assert res["devices"] == ["cpu"] * 4 and res["device"] == "cpu"
    assert np.isfinite(dp["losses"]).all() and dp["losses"] == pytest.approx(fsdp["losses"], abs=1e-4)
    assert fsdp["built_peak_bytes"] > 0 and "built_peak_bytes" not in dp
    assert "Self CPU" in fsdp["profile"] and "profile" not in dp
    assert json.loads(out.read_text())["layouts"]["fsdp"]["losses"] == fsdp["losses"]
