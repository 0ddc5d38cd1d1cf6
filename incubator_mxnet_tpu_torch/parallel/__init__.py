"""Parallel attention helpers of the PyTorch port."""
