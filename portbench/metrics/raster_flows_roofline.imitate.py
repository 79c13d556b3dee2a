"""K1 (`ops/rasterizer_cuda.raster_flows`: binning, walk and flow epilogue)
against its roofline: the summed least time of the traced window's calls,
from each call's faces, bytes and operations (`yardstick.raster_flows_bound_s`),
over the summed device time of K1's kernels, in percent."""
from portbench.lib.trace import K1_KERNELS, device_seconds


def read(run):
    bound = run.counters.get("k1_bound_s", 0.0)
    spent = device_seconds(run.kernels, lambda n: bool(K1_KERNELS.search(n)))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
