"""A sequence-indexing and query engine on JAX for accelerators.

A from-scratch reimplementation of the capabilities of GenSpectrum/LAPIS-SILO
(reference: the LAPIS-SILO sources) designed for accelerator hardware:

- The per-(position, symbol) Roaring bitmap index becomes dense packed-u32
  bitplane tensors in device memory (``[rows, words]`` where bit ``i`` of word ``w``
  is sequence id ``w*32+i``).
- The filter-expression tree compiles to a small IR of bitwise ops that is
  evaluated as one register-machine program per query or batch (a CUDA
  kernel on the GPU, XLA on the CPU) with fused popcount reductions.
- Partitions shard across a ``jax.sharding.Mesh``; queries broadcast; counts
  and per-position histograms merge via ``psum``-style collectives.

The logical model (database_config.yaml schema, the JSON query language, the
JSON responses, snapshot versioning, the two-mode CLI) is kept exactly so the
reference's end-to-end conformance corpus passes unchanged.
"""

__version__ = "0.1.0"
