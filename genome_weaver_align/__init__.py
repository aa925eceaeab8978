"""genome_weaver_align — a short-read alignment engine on JAX for the GPU.

A from-scratch reimplementation of the capabilities of the Java reference
``xerial/genome-weaver-align`` (BWT/FM-index short-read aligner; see
SURVEY.md for the structural analysis) in an idiomatic JAX/XLA/Pallas
design:

- 2-bit packed DNA sequences and a device-resident bit-packed FM-index
  (BWT words + sampled occurrence checkpoints + sparse suffix array).
- Batched, dense-tensor search state machines (exact backward search,
  bidirectional 2BWT search, suffix-filter approximate search) advanced in
  lockstep under ``jax.lax`` control flow — no per-read priority queues.
- A banded edit-distance wavefront verifier (a Pallas kernel on the GPU).
- Scaling via ``jax.sharding`` meshes: reads data-parallel, the index
  replicated or sharded by BWT interval with collective merges.

Package layout (SURVEY.md §2 component numbers in parentheses):

- ``utils``    — packed DNA (#1), bit vectors (#2), large arrays (#3),
                 FASTA/FASTQ IO (#14), SAM emission (#15), simulator,
                 config/logging (#16, #17).
- ``index``    — suffix-array construction (#4), BWT/index build + files
                 (#5), occurrence tables (#6), sparse SA (#7).
- ``ops``      — device kernels: rank/occ (#6 device side), banded DP
                 verify (#11, #12), popcount primitives.
- ``models``   — the aligner "model families": FM-index facade (#8),
                 exact aligner, bidirectional search (#9), suffix filter
                 (#10), full pipeline (#13).
- ``parallel`` — meshes, data-parallel read streaming, interval-sharded
                 index, collective merges.
"""

__version__ = "0.1.0"
