"""Measurement scripts of the port (``python -m r2d2_tpu_torch.tools.<name>``)."""
