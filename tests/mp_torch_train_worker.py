"""Worker process of ``tests/test_torch_multiprocess_train.py`` (not collected by pytest).

Each of two processes joins ``torch.distributed`` over gloo on the CPU
(``parallel.mesh.runtime_init`` from ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR`` / ``MASTER_PORT``) with two ``cpu`` positions, so the two
form a 4-position data axis across the process boundary, and runs the
port's whole ``CLIPTrainer`` twice: the data-parallel step, then FSDP (the
parameter blocks split between the processes). Cross-process gathers in the
loss and the parameters, the gradient all-reduce, per-process data
sharding, the coordinator's early-stop monitor broadcast, the checkpoint
gather and coordinator gating all run for real.

Usage: ``python mp_torch_train_worker.py <rank> <world> <port> <outdir>``;
writes ``<outdir>/p<rank>.json`` and ``<outdir>/<mode>_p<rank>.pt`` (the
final parameters).
"""

import json
import os
import sys


def main() -> None:
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.torch_train_fixtures import build, mp_config  # noqa: E402
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime, runtime_init
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as T
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    assert runtime_init() == "gloo"
    report = {"rank": rank}
    for mode in ("dp", "fsdp"):
        model, pipe = build()
        rt = MeshRuntime.create(MeshConfig(data_parallel=4, fsdp=mode == "fsdp"), [torch.device("cpu")] * 2)
        cfg = mp_config(os.path.join(out, f"ckpt_{mode}"))
        trainer = T.CLIPTrainer(model, pipe, pipe, cfg, out_dir=os.path.join(out, f"{mode}_p{rank}"), rt=rt)
        result = trainer.train()
        torch.save(trainer.params(), os.path.join(out, f"{mode}_p{rank}.pt"))
        b0 = next(iter(pipe.epoch_batches(cfg.batch_size, epoch=0, shuffle=True, seed=cfg.seed, drop_last=True,
                                          num_shards=world, shard_index=rank)))
        report[mode] = {
            "epochs_run": result["epochs_run"],
            "best_epoch": result["best_epoch"],
            "monitors": [r["monitor"] for r in result["history"]],
            "steps": [r["steps"] for r in result["history"]],
            "final_loss": result["history"][-1]["train"]["loss"],
            "first_batch_indices": [int(i) for i in b0.indices],
            "state_bytes": trainer.state.layout.position_bytes(trainer.state.optimizer.moment_tensors())
            if trainer.state.layout is not None else None,
        }
    with open(os.path.join(out, f"p{rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
