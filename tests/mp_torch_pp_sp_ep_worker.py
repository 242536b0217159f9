"""Worker process of ``tests/test_torch_pp_sp_ep_multiprocess.py`` (not collected by pytest).

Each of two processes joins ``torch.distributed`` (gloo on the CPU; NCCL
with a card a rank when ``tests/test_torch_cuda.py`` launches it with
``cuda``) and runs the port's ``pipeline_apply``, ``ring_attention``,
``sp_block_apply`` and expert-sharded ``moe_apply`` forward and backward
over every layout of :data:`CASES`:

- case A, the axis spans the processes: 2 positions a process (axis size 4)
  and 1 (size 2). Each rank gets inputs whose rows it must not read (other
  ranks' stages, sequence shards, experts) filled with NaN, so only real
  hops give a finite, right answer;
- case B, ``data`` spans the processes and the axis lies inside each: every
  process computes its own row.

The inputs are made here from a numpy seed (the parent makes the same
ones). Each rank writes ``<outdir>/r<rank>.pt``: per case the output, the
gradients, its own positions and the hops' log.

Usage: ``python mp_torch_pp_sp_ep_worker.py <rank> <world> <port> <outdir> [cuda]``.
"""

import os
import sys

import numpy as np

# name, function, mesh axes, this process's grid shape
CASES = [
    (f"{kind} {tag}", kind, axes, local)
    for kind, axis in (("pp", "pipe"), ("ring", "seq"), ("block", "seq"), ("moe", "expert"))
    for tag, axes, local in (("A4", (axis,), (2,)), ("A2", (axis,), (1,)), ("B", ("data", axis), (1, 2)))
]
PIPE_MICRO, PIPE_SHAPE = 5, (2, 8)
QKV_SHAPE = (2, 2, 32, 8)
BLOCK_X, BLOCK_HEADS = (2, 16, 32), 2
MOE_X, MOE_HIDDEN, MOE_EXPERTS = (2, 12, 16), 32, 8


def axis_of(axes):
    return axes[-1]


def inputs(kind: str, size: int) -> dict:
    """The case's inputs (numpy, f32) for an axis of ``size`` positions, and
    ``"w"``: the weights of the loss ``sum(out * w)``."""
    rng = np.random.default_rng({"pp": 0, "ring": 1, "block": 2, "moe": 3}[kind] * 10 + size)

    def f32(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if kind == "pp":
        d = PIPE_SHAPE[-1]
        out = {"layers": [{"w": f32((d, d), 0.2), "b": f32(d, 0.1)} for _ in range(2 * size)],
               "xs": f32((PIPE_MICRO,) + PIPE_SHAPE)}
        out["w"] = f32(out["xs"].shape)
    elif kind == "ring":
        out = {"q": f32(QKV_SHAPE), "k": f32(QKV_SHAPE), "v": f32(QKV_SHAPE), "w": f32(QKV_SHAPE)}
    elif kind == "block":
        w = BLOCK_X[-1]
        out = {"x": f32(BLOCK_X), "w": f32(BLOCK_X), "params": {
            "ln_1.weight": 1 + f32(w, 0.1), "ln_1.bias": f32(w, 0.1),
            "attn.in_proj_weight": f32((3 * w, w), 0.2), "attn.in_proj_bias": f32(3 * w, 0.1),
            "attn.out_proj.weight": f32((w, w), 0.2), "attn.out_proj.bias": f32(w, 0.1),
            "ln_2.weight": 1 + f32(w, 0.1), "ln_2.bias": f32(w, 0.1),
            "mlp.c_fc.weight": f32((4 * w, w), 0.2), "mlp.c_fc.bias": f32(4 * w, 0.1),
            "mlp.c_proj.weight": f32((w, 4 * w), 0.1), "mlp.c_proj.bias": f32(w, 0.1)}}
    else:
        w, e = MOE_X[-1], MOE_EXPERTS
        out = {"x": f32(MOE_X), "w": f32(MOE_X), "params": {
            "router": {"kernel": f32((w, e), 1 / np.sqrt(w))},
            "w_in": f32((e, w, MOE_HIDDEN), 1 / np.sqrt(w)), "b_in": f32((e, MOE_HIDDEN), 0.1),
            "w_out": f32((e, MOE_HIDDEN, w), 1 / np.sqrt(MOE_HIDDEN)), "b_out": f32((e, w), 0.1)}}
    return out


def size_of(axes, local, world) -> int:
    """The axis' global size: across the processes when it leads."""
    return local[0] * world if len(axes) == 1 else local[-1]


def own_rows(kind: str, size: int, positions, total: int):
    """The index ranges (along the cut dimension) of the positions: stages,
    sequence shards or experts."""
    per = total // size
    return [slice(p * per, (p + 1) * per) for p in positions]


def compute(kind: str, data: dict, mesh, nan_positions=None) -> dict:
    """Run one function forward and backward on ``mesh``: its output, the
    gradients and (with ``nan_positions``, the positions whose rows this
    rank must not read) NaN in those rows."""
    import torch

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import ep as EP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import pp as PP
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import sp as SP

    dev = mesh.first_device
    axis = mesh.axis_names[-1]
    size = mesh.shape[axis]

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    def poison(x, dim, total):
        if nan_positions:
            for sl in own_rows(kind, size, nan_positions, total):
                x.narrow(dim, sl.start, sl.stop - sl.start).fill_(float("nan"))
        return x.requires_grad_()

    w = t(data["w"])
    if kind == "pp":
        stacked = PP.stack_stages([{k: t(v) for k, v in p.items()} for p in data["layers"]], size)
        stacked = {k: poison(v.detach().clone(), 0, size) for k, v in stacked.items()}
        xs = t(data["xs"]).requires_grad_()
        out = PP.pipeline_apply(lambda p, x: x + torch.tanh(x @ p["w"] + p["b"]), stacked, xs, mesh, axis)
        (out * w).sum().backward()
        grads = dict({f"stage.{k}": v.grad for k, v in stacked.items()}, xs=xs.grad)
    elif kind == "ring":
        q, k, v = (poison(t(data[n]), 2, QKV_SHAPE[2]) for n in "qkv")
        out = SP.ring_attention(q, k, v, mesh, axis, causal=True)
        (out * w).sum().backward()
        grads = {"q": q.grad, "k": k.grad, "v": v.grad}
    elif kind == "block":
        x = poison(t(data["x"]), 1, BLOCK_X[1])
        params = {n: t(a).requires_grad_() for n, a in data["params"].items()}
        out = SP.sp_block_apply(params, x, mesh, heads=BLOCK_HEADS, axis=axis, causal=True)
        (out * w).sum().backward()
        grads = dict({f"param.{n}": p.grad for n, p in params.items()}, x=x.grad)
    else:
        params = {n: poison(t(a), 0, MOE_EXPERTS) for n, a in data["params"].items() if n != "router"}
        params["router"] = {"kernel": t(data["params"]["router"]["kernel"]).requires_grad_()}
        x = t(data["x"]).requires_grad_()
        out, aux = EP.moe_apply(params, x, k=2, mesh=mesh, axis=axis)
        ((out * w).sum() + aux).backward()
        grads = dict({f"param.{n}": params[n].grad for n in ("w_in", "b_in", "w_out", "b_out")},
                     router=params["router"]["kernel"].grad, x=x.grad)
        grads["aux"] = aux.detach()
    return {"out": out.detach().cpu(), "grads": {k: g.detach().cpu() for k, g in grads.items()}}


def main() -> None:
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    on_cards = sys.argv[5:] == ["cuda"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    if on_cards:
        os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh, axis_row, runtime_init
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.sharding import hop_log

    backend = runtime_init()
    assert backend == ("nccl" if on_cards else "gloo"), backend
    dev = torch.device("cuda", torch.cuda.current_device()) if on_cards else torch.device("cpu")
    cases = [c for c in CASES if not on_cards or c[0] in ("pp A2", "moe A2")]
    report = {"backend": backend}
    for name, kind, axes, local in cases:
        arr = np.empty(int(np.prod(local)), dtype=object)
        arr[:] = [dev] * arr.size
        mesh = Mesh(arr.reshape(local), axes, process_index=rank, process_count=world, group=dist.group.WORLD)
        row = axis_row(mesh, axis_of(axes))
        hop_log.reset()
        res = compute(kind, inputs(kind, row.size), mesh,
                      [p for p in range(row.size) if p not in row.devices] if row.group is not None else None)
        res.update(positions=row.positions, spans=row.group is not None, hops=hop_log.snapshot())
        report[name] = res
    torch.save(report, os.path.join(out_dir, f"r{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
