"""The whole step's share of the chip's peak: the nominal operations of the
frames computed in the traced window (padded frames included; the
generator's convolutions, transposed convolutions and attention products,
`yardstick.count_flops`) over the window's seconds over the TF32
tensor-core peak (495 TFLOP/s), in percent."""
from portbench.lib.yardstick import PEAK_TF32_FLOPS


def read(run):
    c = run.counters
    if run.window_s <= 0 or not c.get("frames_computed"):
        return None
    ops = c["frames_computed"] * c["frame_flops"] + c.get("setup_source_calls", 0) * c["setup_flops"]
    return 100.0 * ops / run.window_s / PEAK_TF32_FLOPS
