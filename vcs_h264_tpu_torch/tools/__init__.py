"""Command-line tools of the port (counterparts of the JAX package's
`tools/`), each run as `python -m vcs_h264_tpu_torch.tools.<name>`."""
