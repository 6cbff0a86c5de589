"""Training-side state: the checkpoint layout (so far)."""
