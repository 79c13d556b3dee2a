"""Device milliseconds of convolutions per train step (the profiler's
`convolutions` class over the traced steps): the trainer layer
(`trainers/lwg_trainer.train_step`, `discriminators`, `criterions`)."""
from portbench.lib.trace import device_seconds, kernel_kind


def read(run):
    steps = run.counters.get("steps", 0)
    if not run.kernels or not steps:
        return None
    return 1e3 * device_seconds(run.kernels, lambda n: kernel_kind(n) == "convolutions") / steps
