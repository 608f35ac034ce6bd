"""Synthetic data generators (copies of the reference's, numpy only)."""
