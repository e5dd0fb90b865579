"""Command-line apps (`python -m lux_tpu_torch.apps.pagerank`)."""
