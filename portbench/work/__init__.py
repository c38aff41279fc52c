"""Frozen operation and byte counts of the port's kernels."""
