"""Runnable walkthroughs of the port (``python3 -m
gpmpc_tpu_torch.examples.<name>``)."""
