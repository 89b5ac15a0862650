"""The Monte Carlo engine."""
