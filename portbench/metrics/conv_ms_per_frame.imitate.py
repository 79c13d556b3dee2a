"""Device milliseconds of the generator's convolutions per frame delivered
(the profiler's `convolutions` class over the traced window): the generator
layer (`models/networks/generators`, `blocks`)."""
from portbench.lib.trace import device_seconds, kernel_kind


def read(run):
    frames = run.counters.get("frames", 0)
    if not run.kernels or not frames:
        return None
    return 1e3 * device_seconds(run.kernels, lambda n: kernel_kind(n) == "convolutions") / frames
