"""The benchmark of mpopis_tpu_torch on one H100: see README.md."""
