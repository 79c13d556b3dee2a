"""The whole sharded call's share of the cards' peak: the nominal operations
of the frames computed in the traced window (each clip padded to a multiple
of the cards; the generator's convolutions, transposed convolutions and
attention products, `yardstick.count_flops`) over the window's seconds over
the TF32 tensor-core peak (495 TFLOP/s) of every card the cell uses, in
percent."""
from portbench.lib.yardstick import PEAK_TF32_FLOPS


def read(run):
    c = run.counters
    if run.window_s <= 0 or not c.get("frames_computed"):
        return None
    return 100.0 * c["frames_computed"] * c["frame_flops"] / run.window_s / (PEAK_TF32_FLOPS * run.devices)
