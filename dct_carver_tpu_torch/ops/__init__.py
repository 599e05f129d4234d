"""Plain PyTorch ops: DCT energy, seam DP, the carve loop."""
