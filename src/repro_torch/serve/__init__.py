"""Serve engines of the port."""
