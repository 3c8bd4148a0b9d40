"""Device ops: resize matrices, colour conversion, the fused pipeline."""
