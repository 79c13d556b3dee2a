"""Device milliseconds per frame delivered of the work that is neither a
convolution, nor a hand-written kernel of the port, nor a copy: layout,
elementwise, attention fuse, warps and the composite of
`models/imitator.synthesize_frames`."""
from portbench.lib.trace import device_seconds, kernel_kind


def read(run):
    frames = run.counters.get("frames", 0)
    if not run.kernels or not frames:
        return None
    pick = lambda n: kernel_kind(n) in ("other", "binning_sort_scan")
    return 1e3 * device_seconds(run.kernels, pick) / frames
