"""Multi-device execution of the port: the data mesh, the sharded index
mode and multi-process runs.

Port of bowtie2_tpu/dist/. The reference's parallelism is threads over
reads with one shared read-only index a node (bt2_search.cpp:4874-4897);
here:

- `mesh.py`: a `Mesh` of torch devices on one axis, "data" (whole
  batches sent to its devices in turn, each with its own copy of the
  index: `BatchAligner(mesh=)`) or "shard" (the index split over its
  devices); a device may repeat, which is how one card stands in for
  several;
- `sharded.py`: the sharded index mode (`BatchAligner(shard_mesh=)`): the
  FM rows, mark rows, SA samples and reference words split over the shard
  axis, each row read from its owner shard inside the kernels;
- `multihost.py`: one process a host (or card), each aligning its
  round-robin share of the input's windows, merged in input order.

Output is byte-identical to a one-device run in every mode.
"""
