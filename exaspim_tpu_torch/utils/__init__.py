"""Step timing."""
