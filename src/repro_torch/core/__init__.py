"""Quantization core of the port: grid, packing, configs, SmolLinear."""
