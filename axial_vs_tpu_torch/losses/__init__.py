"""See the package docstring of axial_vs_tpu_torch."""
