"""Device idle milliseconds a train step whose gap began inside one of the
program's `train.*` spans (`trainers/lwg_trainer._train_step`): the gaps in
the union of the traced window's kernels, each put under the innermost span
open when it began, over the window's `train.step` spans."""
from portbench.lib.program_spans import idle_by_span, named, spans_of


def read(run):
    spans = spans_of(run)
    steps = len(named(spans or [], "train.step"))
    if not run.kernels or not steps:
        return None
    idle = idle_by_span(run.kernels, list(spans) + list(run.spans))
    return 1e3 * sum(v for k, v in idle.items() if k.startswith("train.")) / steps
