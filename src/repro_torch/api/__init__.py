"""Lifecycle transforms of the port (deploy packing so far)."""
