"""The training drivers of the port: each module is the twin of one JAX
driver of the repository's `scripts/` under the same name, and runs as
`python -m ipercore_tpu_torch.scripts.<name>` with that driver's flags.
Scenes are drawn on the device by `tools/synth_data.py` (K1 on every batch);
weights are written in the JAX package's flat `.npz` layout, f16."""
