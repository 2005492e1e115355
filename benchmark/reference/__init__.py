"""The plain reference: the codec in plain PyTorch and a reader of the
`.vcs` container. Imports nothing of the program under test."""
