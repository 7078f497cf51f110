"""See the package docstring of mvsnerf_tpu_torch."""
