"""Numeric ops: k-means and quantization error."""
