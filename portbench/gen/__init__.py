"""Frozen generators of the benchmark's genomes and reads."""
