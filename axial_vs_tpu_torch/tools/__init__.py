"""Command-line tools of the port: ``python3 -m axial_vs_tpu_torch.tools.<name>``."""
