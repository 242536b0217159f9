"""The plain reference against the port's CPU path at a toy size: the
towers in float32, the int8 serving tower, and a training step."""


import pytest
import torch

from port_bench import gen
from port_bench.runners.common import port_model, vocabulary
from port_bench.reference import clip as ref_clip
from port_bench.reference.train import Trainer
from port_bench.tests import tiny

A = gen.Arch.from_config(tiny.TINY_CONFIG)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ids():
    _, maker, tok = vocabulary(dict(tiny.SEARCH))
    _, queries = gen.query_batches(maker, 3, dict(tiny.SEARCH), 3)[2]
    return torch.from_numpy(tok(queries)[:, :32])


def test_towers_equal_the_ports_in_f32(ids):
    w = gen.clip_weights(A, 1, CPU)
    model = port_model(A, {n: t.clone() for n, t in w.items()}, dtype=torch.float32)
    images = torch.randn(4, 28, 28, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        t_port = torch.nn.functional.normalize(model.encode_text(ids), dim=-1)
        i_port = torch.nn.functional.normalize(model.encode_image(images), dim=-1)
        t_ref = ref_clip.encode_text(w, ids, A)
        i_ref = ref_clip.encode_image(w, images, A)
    assert torch.allclose(t_port, t_ref, atol=1e-5)
    assert torch.allclose(i_port, i_ref, atol=1e-5)


def test_int8_tower_equals_the_ports_int8_plan(ids):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import encode_text_fast, make_text_plan

    w = gen.clip_weights(A, 2, CPU)
    model = port_model(A, {n: t.clone() for n, t in w.items()}, dtype=torch.float32)
    port_arch = model.arch
    plan = make_text_plan(model, dtype=torch.float32, quantize="int8")
    with torch.no_grad():
        got = torch.nn.functional.normalize(encode_text_fast(port_arch, plan, ids), dim=-1)
        want = ref_clip.encode_text(w, ids, A, ref_clip.Quant(8, tiny.SEARCH["int8"]["ff_group"]))
        far = ref_clip.encode_text(w, ids, A, ref_clip.Quant(4, tiny.SEARCH["int8"]["ff_group"]))
    assert torch.linalg.vector_norm(got - want, dim=1).max() < 1e-4
    assert torch.linalg.vector_norm(far - want, dim=1).max() > 0.05


def test_train_step_equals_the_ports_in_f32(ids):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    recipe = dict(tiny.TRAIN["recipe"])
    w = gen.clip_weights(A, 3, CPU)
    model = port_model(A, {n: t.clone() for n, t in w.items()}, dtype=torch.float32)
    cfg = TrainConfig(batch_size=4, **recipe)
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, 4, model))
    step = trainer.make_train_step(model, cfg)
    ref = Trainer(w, A, recipe, 4, remat=False)
    g = torch.Generator().manual_seed(1)
    for i in range(2):
        q, t = (ids[:4], ids[4:8]) if i == 0 else (ids[4:8], ids[:4])
        batch = {"images": torch.randn(4, 28, 28, 3, generator=g), "query_ids": q, "target_ids": t}
        state, m = step(state, batch)
        loss, _ = ref.step(batch["images"], batch["query_ids"], batch["target_ids"])
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    for n, p in model.named_parameters():
        d_port = float(torch.linalg.vector_norm(p.detach() - w[n]))
        d_ref = float(torch.linalg.vector_norm(ref.w[n].detach() - w[n]))
        assert d_port == pytest.approx(d_ref, rel=2e-3, abs=1e-7), n
