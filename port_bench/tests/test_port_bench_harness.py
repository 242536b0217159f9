"""The harness on the CPU at toy sizes: a cell found by name from data files
alone, the result line's schema, the refusal without a card, and no module
of JAX or the JAX package loaded by a run."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.tests import tiny

REPO = Path(__file__).resolve().parent.parent.parent


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), tiny.tiny_bench())


def run(root, workload, trace=0, seconds=1.0, seed=2 ** 31 + 7):
    result = harness.execute(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds),
                                    "--trace", str(trace)], root=root, require_chip=False)
    return result


def check_schema(result, trace):
    assert list(result)[-1] == "compared"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert isinstance(result["correct"], bool) and result["attempted"] > 0 and result["failed"] == 0
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert dev["window_s"] > 0 and "busy_s" in dev
        for part in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][part]) <= 10
    for c in result["compared"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_end_to_end_line(root, workload):
    result = run(root, workload)
    check_schema(result, 0)
    assert result["correct"]
    spec = harness.Spec(root)
    assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(workload)}


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_traced_line(root, workload):
    result = run(root, workload, trace=1)
    check_schema(result, 1)
    assert result["correct"]
    spec = harness.Spec(root)
    names = {m["name"] for m in spec.per_layer(workload)}
    assert set(result["metrics"]) <= names  # a reader with nothing to read is left out


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added as
    files and entries only; no harness file changes."""
    bench = tiny.tiny_bench()
    root = tiny.make_root(tmp_path, bench)
    before = {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*.py")}
    cfg = dict(tiny.TINY_CONFIG)
    cfg["text_config"] = dict(cfg["text_config"], num_hidden_layers=1)
    (root / "port_bench" / "configs" / "tiny-1l.json").write_text(json.dumps(cfg))
    traffic = dict(tiny.SEARCH, k=3, batch=4)
    (root / "port_bench" / "traffic" / "tiny.search.k3.json").write_text(json.dumps(traffic))
    (root / "port_bench" / "limits" / "tiny1.search.k3.json").write_text(json.dumps(tiny.LIMITS["search"]))
    (root / "port_bench" / "metrics" / "queries_per_batch.search.py").write_text(
        "def read(run):\n    w = run.plain\n    n = w.counts.get('batches')\n    return w.counts['queries'] / n if n else None\n")
    bench["configs"].append({"name": "tiny-1l", "source": "toy", "file": "port_bench/configs/tiny-1l.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "tiny1.search.k3", "config": "tiny-1l", "traffic": "tiny.search.k3",
                               "chips": 1, "why": "toy"})
    bench["per_layer"].append({"name": "queries_per_batch.search", "unit": "queries", "better": "higher",
                               "source": "program_counter", "layer": "retriever", "moves": "search_qps",
                               "workloads": ["tiny1.search.k3"]})
    for m in bench["end_to_end"]:
        if "tiny.search" in m.get("workloads", []):
            m["workloads"].append("tiny1.search.k3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run(root, "tiny1.search.k3", trace=1)
    assert result["metrics"]["queries_per_batch.search"]["value"] == 4.0
    after = {p.relative_to(root): p.read_bytes() for p in (root / "port_bench").rglob("*.py")
             if p.relative_to(root) in before}
    assert after == before


def test_a_per_layer_metric_lists_its_cells(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    spec = harness.Spec(root)
    spec.data = bench
    with pytest.raises(harness.Refused, match="lists no workloads"):
        spec.per_layer("tiny.search")


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_host_clock_metrics_read_the_measured_window(root, workload, monkeypatch):
    """With --trace 1 the MFU and the host spans come from the window that
    ran without the profiler, the device times from the traced one."""
    seen = {}
    real = harness.measure

    def spy(run, t_start):
        real(run, t_start)
        seen["run"] = run

    monkeypatch.setattr(harness, "measure", spy)
    result = run(root, workload, trace=1)
    r = seen["run"]
    assert r.plain is not r.traced and r.plain.window_s > 0 and r.traced.window_s > 0
    unit = "batches" if workload == "tiny.search" else "steps"
    slow = result["metrics"][f"trace_slowdown.{workload.split('.')[1]}"]["value"]
    assert slow == pytest.approx((r.plain.counts[unit] / r.plain.window_s) / (r.traced.counts[unit] / r.traced.window_s))
    mfu = "search_mfu" if workload == "tiny.search" else "train_mfu"
    assert result["metrics"][mfu]["value"] == pytest.approx(harness.Spec(root).reader(mfu)(r))
    r.plain.window_s *= 2
    assert harness.Spec(root).reader(mfu)(r) == pytest.approx(result["metrics"][mfu]["value"] / 2)


def test_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "l14.search.text.1m", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


def test_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "l14.search.text.1m", "--seed", "3",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "knowledge_enhanced_multimodal_retrieval_tpu_torchlike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "knowledge_enhanced_multimodal_retrieval_tpu.models", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert harness.forbidden_modules() == ["jax.numpy", "knowledge_enhanced_multimodal_retrieval_tpu.models"]


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_a_run_loads_no_jax(root, workload):
    code = ("import sys, json; sys.path.insert(0, %r); from port_bench import harness; "
            "r = harness.execute(['--workload', %r, '--seed', '5', '--seconds', '0.5', '--trace', '1'], "
            "root=%r, require_chip=False); "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'knowledge_enhanced_multimodal_retrieval_tpu'))))") % (str(REPO), workload, str(root))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
