"""Checkpoints in the reference's format (``checkpoint``): atomic,
sha256-manifested, readable by ``repro.ckpt`` and written by it."""
