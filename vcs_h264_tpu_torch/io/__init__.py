"""The `.vcs` container (`io.bitstream`: `save_vcs`, `load_vcs`)."""
