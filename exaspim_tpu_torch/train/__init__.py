"""Checkpoint restore (training itself is a later slice)."""
