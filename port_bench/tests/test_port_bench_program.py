"""The program's spans read by ``port_bench/program_trace.py``, on the CPU: the
reduction of synthetic traces, and whole toy runs with the recorder, with
``--trace 0``, and against a program that has no recorder."""

import pytest

from port_bench import harness, program_trace
from port_bench import trace as tr
from port_bench.tests import tiny

US = 1000  # the events' clock is in ns


def ev(name, start, end, device=False, corr=0, thread=1, launch=False):
    return tr.Event(name, start * US, end * US, device, corr=corr, thread=thread, launch=launch)


def synthetic(with_program=True):
    """A 100 us window on thread 1: ``pb:tokenize`` around the program's
    tokenize, ``pb:encode`` around its encode, which launches one 20 us
    device operation; a worker thread with a span of its own."""
    events = [
        ev("pb:window", 0, 100), ev("pb:tokenize", 10, 40), ev("pb:encode", 40, 60),
        ev("cudaLaunchKernel", 45, 46, corr=5, launch=True), ev("gemm", 50, 70, device=True, corr=5),
        ev("kemr:train.feed.place", 0, 100, thread=2),
    ]
    if with_program:
        events += [ev("kemr:retrieval.tokenize", 12, 38), ev("kemr:retrieval.encode", 41, 59),
                   ev("kemr:retrieval.dispatch", 9, 61)]
    return events


def test_gaps_go_to_the_innermost_span_of_either_prefix():
    r = program_trace.ProgramReduction(synthetic())
    want = {"no span": 9 + 30, "kemr:retrieval.dispatch": 1, "tokenize": 2 + 2, "kemr:retrieval.tokenize": 26,
            "encode": 1, "kemr:retrieval.encode": 9}
    assert r.idle_gaps.keys() == want.keys()
    for k, v in want.items():
        assert r.idle_gaps[k] == pytest.approx(v * US / 1e9), k
    assert sum(r.idle_gaps.values()) == pytest.approx(80 * US / 1e9)
    # device time by program span, beside the harness's, which reads the pb: spans alone as before
    assert r.program_device_s == {"retrieval.encode": pytest.approx(20e-6), "retrieval.dispatch": pytest.approx(20e-6)}
    plain = tr.Reduction(synthetic())
    assert dict(r.device_s) == dict(plain.device_s) == {"encode": pytest.approx(20e-6)}
    assert r.busy_s == plain.busy_s and r.window_s == plain.window_s


def test_spans_that_start_together_nest_by_their_ends():
    events = [ev("pb:window", 0, 100), ev("pb:finish", 10, 50), ev("kemr:retrieval.finish", 10, 40)]
    r = program_trace.ProgramReduction(events)
    assert r.idle_gaps["kemr:retrieval.finish"] == pytest.approx(30 * US / 1e9)
    assert r.idle_gaps["finish"] == pytest.approx(10 * US / 1e9)


def test_device_time_reaches_a_span_opened_many_spans_before():
    """A step's span opens before a hundred kernel spans; a launch after
    them still counts for the step, and one inside a kernel span for both."""
    events = [ev("pb:window", 0, 1000), ev("kemr:train.step", 1, 999)]
    events += [ev("kemr:kernel.k", 10 + 5 * i, 12 + 5 * i) for i in range(100)]
    events += [ev("cudaLaunchKernel", 11, 11, corr=8, launch=True), ev("k", 20, 21, device=True, corr=8),
               ev("cudaLaunchKernel", 995, 995, corr=7, launch=True), ev("k", 996, 998, device=True, corr=7)]
    r = program_trace.ProgramReduction(events)
    assert r.program_device_s == {"train.step": pytest.approx(3e-6), "kernel.k": pytest.approx(1e-6)}
    nest = program_trace.Nest(program_trace.by_thread(events[1:102], keep_prefix=True)[1])
    assert nest.open_at(11 * US) == ["kemr:kernel.k", "kemr:train.step"]
    assert nest.open_at(995 * US) == ["kemr:train.step"] and nest.open_at(1000 * US) == []


def test_a_trace_without_program_spans_reduces_as_before():
    a, b = program_trace.ProgramReduction(synthetic(False)), tr.Reduction(synthetic(False))
    assert a.idle_gaps == b.idle_gaps and dict(a.device_s) == dict(b.device_s)
    assert a.busy_s == b.busy_s and a.n_device_ops == b.n_device_ops and a.program_device_s == {}
    assert a.top_gaps() == b.top_gaps() and a.top_ops() == b.top_ops()


# ---------------------------------------------------------------------------
# whole toy runs
# ---------------------------------------------------------------------------

SEARCH_METRICS = ["tokenize_host_ms.search", "map_host_ms.search", "fetch_wait_ms.search", "bpe_miss_share.search",
                  "corpus_install_s.search"]
TRAIN_METRICS = ["forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
                 "feed_wait_ms.train"]
CELLS = {**{m: ["tiny.search"] for m in SEARCH_METRICS}, **{m: ["tiny.train"] for m in TRAIN_METRICS}}
NEW = {"tiny.search": SEARCH_METRICS, "tiny.train": TRAIN_METRICS}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), tiny.tiny_bench())


def run(root, workload, trace, seed=2 ** 31 + 11):
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", "1", "--trace", str(trace)]
    return program_trace.execute(argv, root=root, require_chip=False, cells=CELLS)


def test_the_metrics_table_is_a_set_of_benchmark_entries():
    for m in program_trace.METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads", "read"}
        assert m["source"] in ("program_span", "program_counter") and m["better"] == "lower"
    assert [m["name"] for m in program_trace.METRICS] == SEARCH_METRICS + TRAIN_METRICS


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_traced_run_reads_the_program(root, workload):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import profiling

    result = run(root, workload, 1)
    assert result["correct"] and list(result)[-1] == "compared"
    names = {m["name"] for m in harness.Spec(root).per_layer(workload)}
    assert set(result["metrics"]) - names == set(NEW[workload])
    for m in NEW[workload]:
        assert result["metrics"][m]["value"] >= 0
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert any(name.startswith("kemr:") for name in gaps)
    plain = result["program"]["plain"]["spans"]
    if workload == "tiny.search":
        assert result["metrics"]["tokenize_host_ms.search"]["value"] > 0
        assert result["metrics"]["corpus_install_s.search"]["value"] > 0
        assert "retrieval.install_corpus" in result["program"]["setup"]["spans"]
        assert plain["retrieval.dispatch"]["calls"] >= plain["retrieval.finish"]["calls"]
        assert result["program"]["plain"]["counters"]["tokenizer.words"] > 0
    else:
        assert plain["train.step"]["calls"] == result["program"]["plain_counts"]["steps"]
        assert result["metrics"]["forward_host_ms.train"]["value"] > 0
    assert not profiling.enabled()  # off again after the run


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_untraced_run_is_the_harness_run(root, workload):
    result = run(root, workload, 0)
    assert set(result["metrics"]) == {m["name"] for m in harness.Spec(root).end_to_end(workload)}
    assert "program" not in result and "breakdown" not in result


@pytest.mark.parametrize("workload", ["tiny.search", "tiny.train"])
def test_a_program_without_the_recorder_gives_the_harness_line(root, workload, monkeypatch):
    """The parent's program has no recorder: the line is ``run.py``'s, with
    the same metric names and a breakdown of harness spans alone."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    assert program_trace.recorder() is None
    result = run(root, workload, 1)
    want = harness.execute(["--workload", workload, "--seed", "5", "--seconds", "1", "--trace", "1"], root=root,
                           require_chip=False)
    assert set(result["metrics"]) == set(want["metrics"])
    assert set(result["breakdown"]) == set(want["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(name.startswith("kemr:") for name, _ in result["breakdown"]["idle_gaps"])
    assert "program" not in result
