"""Runnable examples of the port (python -m prisim_tpu_torch.examples.<name>)."""
