"""Environment-facing types of the PyTorch port."""
