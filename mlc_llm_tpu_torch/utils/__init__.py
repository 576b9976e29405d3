"""Shared utilities: the checkpoint format."""
