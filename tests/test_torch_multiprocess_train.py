"""Training across two processes: the port's only CPU check across a process boundary.

Mirrors ``tests/test_multiprocess.py``: two workers
(``tests/mp_torch_train_worker.py``) join ``torch.distributed`` over gloo,
each with two ``cpu`` positions of one 4-way data axis, and run the whole
``CLIPTrainer`` with the data-parallel step and then with FSDP (each
process holding half of every cut parameter). Both processes must see the
same monitors and make the same stop decision, end with the same
parameters, and match one process running the same global batches over
``[cpu] * 4``; only the coordinator writes metrics. Worker output goes to
files, never pipes (the two are coupled by collectives).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from tests.torch_train_fixtures import build, mp_config

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "mp_torch_train_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_process(tmp, mode):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as T
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    model, pipe = build()
    rt = MeshRuntime.create(MeshConfig(data_parallel=4, fsdp=mode == "fsdp"), [torch.device("cpu")] * 4)
    trainer = T.CLIPTrainer(model, pipe, pipe, mp_config(os.path.join(tmp, f"one_{mode}")), rt=rt,
                            out_dir=os.path.join(tmp, f"one_{mode}_run"))
    result = trainer.train()
    return [r["monitor"] for r in result["history"]], trainer.params()


def test_two_process_dp_and_fsdp_training_agree(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = str(_free_port())
    logs = [open(tmp_path / f"w{r}.log", "w+") for r in range(2)]
    procs = []
    try:
        procs = [subprocess.Popen([sys.executable, _WORKER, str(r), "2", port, str(tmp_path)], env=env, stdout=log,
                                  stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
        one = {mode: _one_process(str(tmp_path), mode) for mode in ("dp", "fsdp")}  # while the workers run
        for p in procs:
            p.wait(timeout=120)
    finally:
        for p in procs:  # never leave a collective-blocked worker behind
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    r0, r1 = (json.loads((tmp_path / f"p{r}.json").read_text()) for r in range(2))
    for mode in ("dp", "fsdp"):
        a, b = r0[mode], r1[mode]
        assert a["epochs_run"] == b["epochs_run"] == 2 and a["best_epoch"] == b["best_epoch"]
        assert a["monitors"] == b["monitors"] and a["steps"] == b["steps"] == [4, 4]
        assert a["final_loss"] == b["final_loss"]
        # each process loads its own half of every global batch
        assert len(a["first_batch_indices"]) == 4 and not set(a["first_batch_indices"]) & set(b["first_batch_indices"])
        p0, p1 = (torch.load(tmp_path / f"{mode}_p{r}.pt") for r in range(2))
        monitors, params = one[mode]
        assert a["monitors"] == pytest.approx(monitors, abs=1e-4)
        for name, v in params.items():
            assert torch.equal(p0[name], p1[name]), name
            torch.testing.assert_close(p0[name], v.detach(), rtol=1e-4, atol=1e-4, msg=name)
        # only the coordinator writes metrics
        assert os.path.exists(tmp_path / f"{mode}_p0" / "train_metrics.jsonl")
        assert not os.path.exists(tmp_path / f"{mode}_p1" / "train_metrics.jsonl")
    # FSDP across the processes: each holds the blocks of its two positions
    assert r0["fsdp"]["state_bytes"] == r1["fsdp"]["state_bytes"] and len(r0["fsdp"]["state_bytes"]) == 2
