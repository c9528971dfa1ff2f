"""Benchmarks of the GPU engine, the reference's verbs, runnable as
``python -m seqalign_torch.bench.suite <verb>`` (on the card; on the CPU
only under ``SEQALIGN_TORCH_DEVICE=cpu``):

* ``timing``: ``device_seconds_per_call`` (CUDA events around back-to-back
  calls) and ``wall_seconds`` (best of N on the host clock);
* ``suite``: the verbs throughput, latency, batch, batch-e2e, maxlength
  and engines (the reference's benchmark grids).

The repository's benchmark, whose cells the ledger records, is
``cellbench/``.
"""
