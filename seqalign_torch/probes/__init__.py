"""Dev probes of the card: the Hopper counterparts of the JAX package's
Pallas probes, each runnable as ``python -m seqalign_torch.probes.<name>``
on a host with a CUDA device.

* ``dpx16`` (P2, ``csrc/probe_dpx16.cu``): which packed int16 formulations
  of the int16 cell mode's operations are exact, and their rates;
* ``walk_costs`` (P1, ``csrc/probe_chase.cu``): the cost of a dependent
  chain of loads from shared memory, L2 and HBM.
"""
