"""Experiment helpers: synthetic datasets with exact ground truth."""
