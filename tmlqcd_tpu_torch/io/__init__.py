"""Checkpoint I/O."""
