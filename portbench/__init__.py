"""The benchmark of `ipercore_tpu_torch` on an NVIDIA H100 (`run.py`)."""
