"""The whole train step's share of the chip's peak: the nominal operations of
the traced steps (`drivers/personalize.step_flops`: a network whose weights
train counts 3 times its forward, a frozen one that passes a gradient back 2
times, a forward without gradient once) over the traced window's seconds
over the TF32 tensor-core peak (495 TFLOP/s), in percent."""
from portbench.lib.yardstick import PEAK_TF32_FLOPS


def read(run):
    c = run.counters
    if run.window_s <= 0 or not c.get("steps"):
        return None
    return 100.0 * c["steps"] * c["step_flops"] / run.window_s / PEAK_TF32_FLOPS
