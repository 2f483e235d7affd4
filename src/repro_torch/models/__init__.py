"""Model code of the port (dense decoder serve path)."""
