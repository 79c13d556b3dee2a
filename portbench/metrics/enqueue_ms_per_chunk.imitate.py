"""Host milliseconds a chunk spends being launched: the mean of the program's
`stream.enqueue` spans (`parallel/streaming.StreamingSynthesizer`: the
chunk's geometry and generator launches and its copy event) over the traced
window: the service loop."""
from portbench.lib.program_spans import mean_ms, spans_of


def read(run):
    spans = spans_of(run)
    return mean_ms(spans, "stream.enqueue") if spans else None
