"""Command-line scripts of the port, run as ``python -m
tpu_qg_torch.scripts.<name>``."""
