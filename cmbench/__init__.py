"""The benchmark of circminer_tpu_torch; see README.md."""
