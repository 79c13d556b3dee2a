"""Host milliseconds a train step spends in the two optimizers: the
program's `train.g_adam` and `train.d_adam` spans (`lwg_trainer.Adam.apply`:
clip, Adam and the finite check over every leaf) over the traced window's
`train.step` spans."""
from portbench.lib.program_spans import named, spans_of


def read(run):
    spans = spans_of(run)
    steps = len(named(spans or [], "train.step"))
    if not steps:
        return None
    adam = named(spans, "train.g_adam") + named(spans, "train.d_adam")
    return sum(s[2] - s[1] for s in adam) / 1e6 / steps
