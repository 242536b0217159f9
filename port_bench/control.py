"""The controls that set each compared number's upper reading, at a cell's
own size: the reference put in the program's place one precision below
what the configuration states, and the faults a cell can have, planted in
that stand-in. The benchmark's own runs never run this.

    python3 port_bench/control.py --workload <name> --seeds <n> [<n> ...]

prints, for every seed, one JSON line a reading: ``{"workload", "seed",
"reading", "compared": {name: value}}``. Search: ``int4`` (weights,
activations and corpus at 4 bits in the place of 8). Training: ``fp8``
(every product of the towers with float8 operands in the place of
bfloat16), ``half`` (half of each batch left out, the mean over the rest)
and ``token`` (one token of every query altered where the batch is made);
a step that leaves the state unchanged reads ``update_gap`` 1 by
construction and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace


def search_readings(run, n_batches: int):
    from port_bench import gen
    from port_bench.checks import search_text as chk
    from port_bench.runners.common import vocabulary

    _, maker, _ = vocabulary(run.traffic)
    pool = gen.query_batches(maker, run.seed, run.traffic, n_batches)
    items = chk.control_items(run, [qs for _, qs in pool], bits=4)
    yield "int4", chk.judge(run, items)


def train_readings(run, faults=("fp8", "half", "token")):
    import numpy as np

    from port_bench import gen
    from port_bench.checks import train_step as chk
    from port_bench.runners.common import vocabulary
    from port_bench.reference import clip as ref_clip

    tr, a = run.traffic, run.arch
    _, maker, _ = vocabulary(tr)
    records = gen.train_records(run.seed, tr, a.image_resolution, maker, run.device)
    b = int(tr["batch"])
    rng = np.random.default_rng(gen.sub_seed(run.seed, "control") % 2 ** 32)
    order = rng.permutation(len(records))
    batches = [order[i * b:(i + 1) * b] for i in range(int(tr["checked_steps"]))]
    run.state = SimpleNamespace(records=records, steps_per_epoch=len(records) // b)
    ref = chk.readings(run, batches)
    for f in faults:
        if f == "fp8":
            got = chk.readings(run, batches, mm=ref_clip.Floats())
        else:
            got = chk.readings(run, batches, fault=f)
        yield f, chk.judge(run, got, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=40, help="search: the batches a seed compares")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the tests' toy cells)")
    p.add_argument("--root", default=None)
    args = p.parse_args(argv)
    root = Path(args.root) if args.root else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    from port_bench import harness

    device = torch.device("cpu" if args.cpu else "cuda:0")
    spec = harness.Spec(root)
    for seed in args.seeds:
        run = harness.Run(spec, args.workload, seed, 0.0, False, device)
        readings = (search_readings(run, args.batches) if run.traffic["runner"] == "search_text"
                    else train_readings(run))
        t = time.perf_counter()
        for name, compared in readings:
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              "compared": {n: v for n, v, _ in compared}, "s": time.perf_counter() - t}),
                  flush=True)
            t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
