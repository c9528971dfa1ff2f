"""Benchmarks of the GPU engine, each runnable as ``python -m
seqalign_torch.bench.<name>`` (on the card; on the CPU only under
``SEQALIGN_TORCH_DEVICE=cpu``):

* ``timing``: ``device_seconds_per_call`` (CUDA events around back-to-back
  calls) and ``wall_seconds`` (best of N on the host clock);
* ``suite``: the verbs throughput, latency, batch, batch-e2e, maxlength
  and engines (the reference's benchmark grids);
* ``headline``: K3's score fill of 8,192 local DNA pairs of 512 x 512 in
  GCUPS, one JSON line;
* ``batch_e2e``: ``BatchAligner.align`` on 65,536 local DNA pairs of
  256 x 256, cold and warm walls, one JSON line.
"""
