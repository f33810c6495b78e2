"""Experiment drivers and the CLI (`python -m mpopis_tpu_torch car ...`)."""
