"""portbench: the benchmark of bowtie2_tpu_torch (see README.md)."""
