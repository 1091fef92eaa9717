"""Measurement tools of the port (counterparts of the repository's
``tools/``), each runnable as ``python -m atropos_tpu_torch.tools.<name>``."""
