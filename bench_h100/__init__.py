"""The H100 benchmark of rocalution_tpu_torch (see README.md)."""
