"""Perception runtime of the port: person detection and tracking, 2D pose,
the person segmenter, and the crop geometry of preprocessing (the twins of
`ipercore_tpu/tools/`, slice by slice)."""
