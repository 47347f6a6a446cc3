"""Checkpoints (``ckpt.checkpoint``)."""
