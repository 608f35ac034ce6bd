"""Core PC-stable modules of the PyTorch port."""
