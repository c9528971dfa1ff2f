"""The benchmark of ``seqalign_torch`` on an NVIDIA card (``run.py``)."""
