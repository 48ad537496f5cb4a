"""Host data path of the PyTorch port: tokenizers and the processor."""
