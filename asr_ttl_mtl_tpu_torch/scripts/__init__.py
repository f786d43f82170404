"""Command-line entry points of the port (`python -m asr_ttl_mtl_tpu_torch.scripts.<name>`)."""
