"""Whether the training window's step is right, judged against the plain
reference (``reference/train.py``, float32, TF32 off).

The reference starts from the same seeded weights and follows the first
steps the program took in set-up through the window's own call and feed,
on the same records: it works their pixels (the published CLIP
preprocessing, PIL's bicubic resize) and token ids (its own BPE) out
again from the records by row index. Compared, each by the worst leaf
against ``max(the reference leaf's norm, the median leaf's)``:

- ``loss_gap``: the largest relative gap between a step's loss and the
  reference's;
- ``grad_gap``: of the norms of each leaf's first gradient as the
  optimizer got it (clipped; the program's from AdamW's first moment after
  one step, ``exp_avg / (1 - beta1)``);
- ``update_gap``: of the norms of each leaf's change over the checked
  steps.

A fused qkv projection counts as three leaves (its query, key and value
parts). Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the last two:
``logit_scale``, which the fixed temperature leaves without a gradient,
and every key bias, which softmax leaves without one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import gen
from ..runners.common import free, vocabulary
from ..reference import clip as ref_clip
from ..reference.bpe import truncate_words
from ..reference.train import Trainer, leaf_gap

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(image: np.ndarray, size: int) -> np.ndarray:
    """CLIP's published preprocessing: shortest edge to ``size`` (bicubic),
    centre crop (offsets rounded half to even), /255, the CLIP mean and
    std."""
    from PIL import Image

    img = Image.fromarray(image)
    w, h = img.size
    nw, nh = (size, int(size * h / w)) if w <= h else (int(size * w / h), size)
    img = img.resize((nw, nh), resample=Image.BICUBIC)
    left, top = int(round((nw - size) / 2.0)), int(round((nh - size) / 2.0))
    x = np.asarray(img.crop((left, top, left + size, top + size)), np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def leaves(named) -> Dict[str, torch.Tensor]:
    """Each tensor by name, a fused qkv projection as its three parts."""
    out = {}
    for n, t in named.items():
        if n.endswith(("in_proj_weight", "in_proj_bias")):
            for part, x in zip("qkv", t.chunk(3, dim=0)):
                out[f"{n}.{part}"] = x
        else:
            out[n] = t
    return out


def norms(named) -> Dict[str, float]:
    named = leaves(named)
    return dict(zip(named, torch.stack(torch._foreach_norm(list(named.values()))).tolist()))


def inputs(run, tok, records, rows: np.ndarray, fault: Optional[str] = None):
    a, dev = run.arch, run.device
    images = np.stack([preprocess(records[int(i)]["image"], a.image_resolution) for i in rows])
    q = tok([truncate_words(records[int(i)]["query_text"]) for i in rows], a.context_length)
    t = tok([truncate_words(records[int(i)]["target_text"]) for i in rows], a.context_length)
    if fault == "token":  # one token of every query altered
        q[:, 1] = (q[:, 1] + 1) % (tok.sot - 1)
    if fault == "half":  # half of the batch left out, the mean over the rest
        keep = len(rows) // 2
        images, q, t = images[:keep], q[:keep], t[:keep]
    return (torch.from_numpy(images).to(dev), torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev))


def recipe(run) -> dict:
    return dict(run.traffic["recipe"])


def readings(run, batches: Sequence[np.ndarray], mm: ref_clip.Exact = ref_clip.Exact(),
             fault: Optional[str] = None) -> dict:
    """The reference (or, with ``mm`` / ``fault``, a control put in the
    program's place) over ``batches``: each step's loss, each leaf's first
    clipped gradient norm and its change's norm after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr, a, dev = run.traffic, run.arch, run.device
    _, _, tok = vocabulary(tr)
    w0 = gen.clip_weights(a, run.seed, dev)
    ref = Trainer(w0, a, recipe(run), run.state.steps_per_epoch, mm, remat=True)
    losses, g1 = [], {}
    for i, rows in enumerate(batches):
        loss, grads = ref.step(*inputs(run, tok, run.state.records, rows, fault))
        losses.append(loss)
        if i == 0:
            g1 = norms(grads)
        del grads
    delta = norms({n: ref.w[n].detach() - w0[n] for n in w0})
    del ref, w0
    free(dev)
    return {"losses": losses, "g1": g1, "delta": delta}


def program_readings(run) -> dict:
    st = run.state
    w0 = gen.clip_weights(run.arch, run.seed, run.device)
    delta = norms({n: st.p3[n].to(run.device) - w0[n] for n in w0})
    del w0
    return {"losses": list(st.losses), "g1": dict(st.g1), "delta": delta}


def judge(run, prog: dict, ref: dict) -> List[Tuple[str, float, float]]:
    lim = run.limits
    g = ref["g1"]
    med = sorted(g.values())[len(g) // 2]
    names = [n for n in g if g[n] >= 1e-3 * med]
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or any(n not in prog["g1"] for n in names):
        loss_gap = float("inf")
    grad_gap, _ = leaf_gap({n: prog["g1"].get(n, 0.0) for n in names}, g, names)
    update_gap, _ = leaf_gap(prog["delta"], ref["delta"], names)
    return [
        ("loss_gap", loss_gap, float(lim["loss_gap"])),
        ("grad_gap", grad_gap, float(lim["grad_gap"])),
        ("update_gap", update_gap, float(lim["update_gap"])),
    ]


def compare(run) -> List[Tuple[str, float, float]]:
    prog = program_readings(run)
    free(run.device)
    return judge(run, prog, readings(run, run.state.firsts))
