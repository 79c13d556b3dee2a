"""K2 (`ops/sampling_cuda.grid_sample_nhwc`, the UV warp of every chunk)
against its roofline: the summed least time of the traced window's calls
(`yardstick.grid_sample_bound_s`) over the summed device time of K2's
kernels, in percent."""
from portbench.lib.trace import K2_KERNELS, device_seconds


def read(run):
    bound = run.counters.get("k2_bound_s", 0.0)
    spent = device_seconds(run.kernels, lambda n: bool(K2_KERNELS.search(n)))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
