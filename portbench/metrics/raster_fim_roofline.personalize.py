"""K3 (`ops/rasterizer_cuda.raster_fim`: binning, walk and fim/wim
epilogue; twice a step, the source views and the target) against its
roofline: the summed least time of the traced steps' calls from their faces
(`yardstick.raster_fim_bound_s`) over the summed device time of K3's
kernels, in percent."""
from portbench.lib.trace import K1_KERNELS, device_seconds


def read(run):
    bound = run.counters.get("k3_bound_s", 0.0)
    spent = device_seconds(run.kernels, lambda n: bool(K1_KERNELS.search(n)))
    if bound <= 0 or spent <= 0:
        return None
    return 100.0 * bound / spent
