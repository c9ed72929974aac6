"""Atomic, checksummed checkpoints."""
