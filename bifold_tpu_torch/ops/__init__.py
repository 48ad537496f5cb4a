"""Tensor operations of the PyTorch port (counterpart of bifold_tpu/ops)."""
