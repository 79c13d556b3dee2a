"""The evaluation drivers of the port: each module is the twin of the JAX
driver of the repository's `scripts/evaluate/` under the same name."""
