"""Device milliseconds per frame of the kernels launched under the program's
`pose2d.paf_stages` and `pose2d.heatmap_stages` spans (`tools/pose2d.
OpenPoseBody25.forward`: the four PAF and the two heatmap stages of dense
3x3 blocks with PReLU and concatenations, at stride 8), over the real frames
of the traced window's clips."""
from portbench.lib.launches import device_s_launched_under


def read(run):
    spent = device_s_launched_under(run, {"pose2d.paf_stages", "pose2d.heatmap_stages"})
    frames = run.counters.get("frames", 0)
    if not spent or not frames:
        return None
    return 1e3 * spent / frames
