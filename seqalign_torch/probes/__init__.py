"""Dev probes of the card, each runnable as ``python -m
seqalign_torch.probes.<name>`` on a host with a CUDA device: the Hopper
counterparts of the JAX package's Pallas probes, and K1's, K5's, K2's
and K3's shapes.

* ``dpx16`` (P2, ``csrc/probe_dpx16.cu``): which packed int16 formulations
  of the int16 cell mode's operations are exact, and their rates;
* ``walk_costs`` (P1, ``csrc/probe_chase.cu``): the cost of a dependent
  chain of loads from shared memory, L2 and HBM;
* ``wavefront_shapes`` (K1, ``csrc/wavefront.cu``): K1 at every shape
  (lanes a slot, steps a lane's iteration), exact and timed, and K1's own
  trace;
* ``strip_shapes`` (K5, ``csrc/strip.cu``): K5 at every shape (rows a
  lane, columns a lane's iteration), exact and timed, and K5's own trace;
* ``walk_shapes`` (K2, ``csrc/walk.cu``): K2 at every window shape
  (slots, word groups), exact and timed, and the walker's own trace;
* ``interpair_shapes`` (K3 and K3-cell16, ``csrc/interpair.cu``,
  ``csrc/interpair16.cu``): the batch fill at every shape (warps a CTA,
  columns a block), exact and timed, and the chain's own trace.
"""
