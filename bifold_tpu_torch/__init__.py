"""bifold_tpu_torch: the PyTorch/CUDA port of bifold_tpu.

A second package beside the JAX reference (``bifold_tpu``), with the same
layout so each module's counterpart sits at the same path. It imports
``torch`` and ``numpy`` only. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, and every Pallas
kernel on the served path is a hand-written CUDA kernel under ``csrc/``.
"""
