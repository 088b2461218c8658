"""Synthetic phantoms, the patch-cache contract and the data loader."""
