"""Synthetic data of the port (pure numpy)."""
