"""Host milliseconds the service loop waits for a chunk's frames: the mean
of the program's `stream.fetch` spans (the wait on the writes that read the
pinned buffer, the side-stream copy and the wait on it) over the traced
window."""
from portbench.lib.program_spans import mean_ms, spans_of


def read(run):
    spans = spans_of(run)
    return mean_ms(spans, "stream.fetch") if spans else None
