"""Two-phase SONIQ training of the port."""
