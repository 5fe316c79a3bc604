"""Quantizer models served by the port: PQ and RVQ."""
