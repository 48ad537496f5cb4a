"""The benchmark harness of the PyTorch/CUDA port (``bifold_tpu_torch``).

``perfbench/run.py`` runs one cell once. Everything that belongs to one
configuration, traffic mix, cell or metric is a file of its own under
``perfbench/``, found by its name (``pb.cells``); this package holds the
general code: the traffic generator (``pb.traffic``), the seeded weights
(``pb.weights``), the work counters and peaks (``pb.work``), the trace
reduction (``pb.trace``), the host spans (``pb.spans``), the comparisons
that decide ``correct`` (``pb.check``) and one driver per kind of entry the
window drives (``pb.entries.<entry>``).
"""
