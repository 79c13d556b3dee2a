"""Device milliseconds per frame of the kernels launched under the program's
`pose2d.stem` spans (`tools/pose2d.OpenPoseBody25.forward`: the VGG stem and
the CPM convolutions, model0, at the input size on the frame and its mirror),
over the real frames of the traced window's clips."""
from portbench.lib.launches import device_s_launched_under


def read(run):
    spent = device_s_launched_under(run, {"pose2d.stem"})
    frames = run.counters.get("frames", 0)
    if not spent or not frames:
        return None
    return 1e3 * spent / frames
