"""Milliseconds of `models/imitator.setup_source` a request: the benchmark's
own span around the call, synchronised at both ends, in the traced window,
mean over its requests."""


def read(run):
    spans = run.counters.get("setup_source_s") or []
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
