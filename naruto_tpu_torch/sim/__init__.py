"""sim (PyTorch port)."""
