"""Percent of the frames computed that are padding: the `padded` attributes of
the program's `stream.run` spans over their `frames` + `padded`, summed over
the clips of the traced window (`parallel/streaming.StreamingSynthesizer`
pads a clip's last chunk with its last frame): the service loop's wasted
work."""
from portbench.lib.program_spans import named, spans_of


def read(run):
    clips = named(spans_of(run) or [], "stream.run")
    frames = sum(s.attrs["frames"] for s in clips)
    padded = sum(s.attrs["padded"] for s in clips)
    if frames + padded <= 0:
        return None
    return 100.0 * padded / (frames + padded)
