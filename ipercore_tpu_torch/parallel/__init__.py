"""Several devices: data-parallel training over `torch.distributed` process
groups (`mesh`), frame-sharded inference driven by one process
(`inference.sharded_synthesize`) and streaming synthesis (`streaming`)."""
