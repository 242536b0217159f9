"""Host milliseconds a batch in the retriever's own work: tokenizing the
queries and mapping the winners' rows to uuids (the harness's spans around
``CLIPRetrieval._tokenize`` and ``_finish_results``), in the measured
window, which runs without the profiler."""


def read(run):
    w = run.plain
    n = w.counts.get("batches", 0)
    if not n or not w.host.get("tokenize") or not w.host.get("finish"):
        return None
    return (sum(w.host["tokenize"]) + sum(w.host["finish"])) / n * 1e3
