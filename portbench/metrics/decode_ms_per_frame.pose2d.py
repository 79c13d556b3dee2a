"""Host milliseconds per frame of the program's `pose2d.decode` spans
(`tools/pose2d.OpenPoseRunner.decode_tracked`: NMS, PAF grouping, the
largest person and the 1-euro filter over a clip, on the host while the
device waits), over the frames those spans decoded in the traced window."""
from portbench.lib.program_spans import named, spans_of


def read(run):
    decodes = named(spans_of(run) or [], "pose2d.decode")
    frames = sum(s.attrs["frames"] for s in decodes)
    if not frames:
        return None
    return sum(s[2] - s[1] for s in decodes) / 1e6 / frames
