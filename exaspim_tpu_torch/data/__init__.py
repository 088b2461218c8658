"""Synthetic phantom volumes."""
