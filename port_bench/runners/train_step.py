"""Fine-tuning: the program's train step (``train.trainer.make_train_step``
on a ``TrainState``) over batches built by its own data path, records
preprocessed and tokenized on the host by ``data.datasets.DataPipeline``
and placed on the card one step ahead by ``train.trainer.device_prefetch``.

Set-up builds the one state the window trains and drives it through the
first steps, which the check follows; ``train_samples_per_s`` counts every
sample of every step the window ran over the whole window, which ends when
the card has finished the last step.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import gen
from ..checks.train_step import norms
from .common import free, port_model, vocabulary


def recipe_config(run):
    """The program's ``TrainConfig`` holding the traffic's recipe."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    tr = run.traffic
    return TrainConfig(batch_size=int(tr["batch"]), seed=gen.sub_seed(run.seed, "order") % (2 ** 31),
                       **tr["recipe"])


def setup(run) -> None:
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline, InMemoryDataset
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import flash_attention as flash
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer

    tr, a, dev, seed = run.traffic, run.arch, run.device, run.seed
    merges, maker, _ = vocabulary(tr)
    records = gen.train_records(seed, tr, a.image_resolution, maker, dev)
    weights = gen.clip_weights(a, seed, dev)
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = port_model(a, weights, remat=bool(run.config.get("train_remat", False)))
    del weights
    cfg = recipe_config(run)
    pipe = DataPipeline(InMemoryDataset(records), CLIPTokenizer(merges), image_size=a.image_resolution,
                        context_length=a.context_length, num_workers=int(tr["workers"]))
    spe = pipe.num_batches(cfg.batch_size)
    state = trainer.TrainState(model, trainer.make_optimizer(cfg, spe, model))
    step = trainer.make_train_step(model, cfg)
    n_checked = int(tr["checked_steps"])
    firsts = []

    def epochs():
        e = 0
        while True:
            yield from pipe.epoch_batches(cfg.batch_size, epoch=e, seed=cfg.seed)
            e += 1

    def place(b):
        if len(firsts) < n_checked:
            firsts.append(np.asarray(b.indices))
        return {"images": torch.from_numpy(b.images).to(dev), "query_ids": torch.from_numpy(b.query_ids).to(dev),
                "target_ids": torch.from_numpy(b.target_ids).to(dev)}

    feed = trainer.device_prefetch(epochs(), place)
    S, P = run.spans, run.patches
    P.wrap(S, state.optimizer, "step", "optimizer")
    P.wrap(S, flash, "flash_attention_kernel", "flash", lambda args, kw, out: tuple(args[0].shape))
    st = run.state = SimpleNamespace(state=state, step=step, feed=feed, records=records, firsts=firsts,
                                     steps_per_epoch=spe, losses=[], g1={}, p3={})
    # the first steps, which the check follows, then the warm-up
    opt = state.optimizer
    for i in range(n_checked):
        state, m = step(state, next(feed))
        st.losses.append(m["loss"].detach())
        if i == 0:
            t = time.perf_counter()
            # a leaf the step never gave to AdamW has no moment: it reads 0
            moments = {n: opt.adamw.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                       for n, p in zip(opt.trainable, opt.params)}
            st.g1 = {n: v / (1 - cfg.beta1) for n, v in norms(moments).items()}
            run.check_s += time.perf_counter() - t
    t = time.perf_counter()
    st.losses = [float(x) for x in st.losses]
    st.p3 = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    run.check_s += time.perf_counter() - t
    for _ in range(int(tr["warmup_steps"])):
        state, _ = step(state, next(feed))
    st.state = state


def window(run, seconds: float, check: bool) -> None:
    st, tr = run.state, run.traffic
    dev = run.device
    n = 0
    feed = run.spans.wrap(lambda: next(st.feed), "feed")  # the wait for the next placed batch
    step = run.spans.wrap(st.step, "step")
    t0 = time.perf_counter()
    stop = t0 + seconds
    state = st.state
    while True:
        state, _ = step(state, feed())
        n += 1
        if time.perf_counter() >= stop:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    run.window_s = time.perf_counter() - t0
    st.state = state
    b = int(tr["batch"])
    run.counts.update(attempted=n, failed=0, steps=n, samples=n * b)
    run.metrics["train_samples_per_s"] = n * b / run.window_s
    host = {k: round(sum(v) / n * 1e3, 3) for k, v in run.spans.host.items()}
    print(f"train: {n} steps of {b} in {run.window_s:.3f} s; host ms a step in each span {host}", file=sys.stderr)


def release(run) -> None:
    st = run.state
    run.patches.restore()
    st.feed.close()
    st.state = st.step = st.feed = None
    free(run.device)
