"""Measurement tools for the port's kernels; they run on the card only."""
