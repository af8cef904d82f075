"""Command-line tools of the PyTorch port (python -m tengine_tpu_torch.tools.<name>)."""
