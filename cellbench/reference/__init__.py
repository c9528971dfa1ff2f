"""The plain reference that decides ``correct``: plain PyTorch and numpy.

It imports nothing of the port (``seqalign_torch``) and nothing of the JAX
package; ``cellbench/tests`` holds it to that.  ``dp`` fills the linear-gap
DP row by row on any torch device and keeps, for each pair, the DP values
in a band of columns around a path; ``verify`` judges an alignment against
the reference tie policy at every cell of its path; ``walk`` walks a path
over the same band under a chosen tie policy (the control).
"""
