"""The benchmark of the `vcs_h264_tpu_torch` port (see `run.py`)."""
