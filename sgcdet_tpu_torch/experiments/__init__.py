"""Measurements of this card's floors that the kernels' design rests on: the
Hopper counterparts of the TPU probes in the repository's experiments/
folder (``probes``)."""
