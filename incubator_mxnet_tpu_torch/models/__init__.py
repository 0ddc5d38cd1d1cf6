"""Models of the PyTorch port."""
