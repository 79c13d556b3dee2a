"""The whole clip's share of the chip's peak: the nominal operations of the
frames the network ran in the traced window (the `frames` and `padded`
attributes of the program's `pose2d.heads` spans: a chunk is padded to a
multiple of 4 frames; each frame two passes of Body-25 at the network's input, the
frame and its mirror; the convolutions, `yardstick.count_flops`) over the
window's seconds over the TF32 tensor-core peak (495 TFLOP/s), in percent."""
from portbench.lib.program_spans import named, spans_of
from portbench.lib.yardstick import PEAK_TF32_FLOPS


def read(run):
    chunks = named(spans_of(run) or [], "pose2d.heads")
    frames = sum(s.attrs["frames"] + s.attrs["padded"] for s in chunks)
    if run.window_s <= 0 or not frames:
        return None
    return 100.0 * frames * run.counters["frame_flops"] / run.window_s / PEAK_TF32_FLOPS
