"""Fault-tolerant numpy checkpoints, on the reference's on-disk format."""
from .manager import CheckpointCorruptError, CheckpointManager  # noqa: F401
