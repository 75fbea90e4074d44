"""Rank 0's device ms a step of the NCCL kernels (parallel.py: the synced
BN moments, the positive count, the flat gradient all-reduce, the metrics
and BN statistics)."""
from benchmark.readers import kernel_ms


def read(trace):
    return kernel_ms(trace, "nccl")
