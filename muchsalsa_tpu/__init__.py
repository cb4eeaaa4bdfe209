"""MuCHSALSA — a hybrid de novo genome assembler on JAX.

A from-scratch reimplementation of the LazyB / MuCHSALSA method
(Gatter et al., Algorithms Mol Biol 16:8, 2021) whose hot stages run on
an accelerator (an NVIDIA GPU) and fall back to exact host paths:

- dense struct-of-arrays match/edge tables instead of pointer graphs
  (reference: ``include/ms/graph/Graph.h``, ``matching/MatchMap.h``),
- batched, bucketized JAX kernels for the O(k^2) anchor-chaining DP
  (reference: ``libms/src/kernel/mpp.cpp``),
- batched edit-distance kernels for base-level alignment (a capability
  the reference delegates to external minimap2 calls,
  ``pipeline/pipeline.sh``),
- ``jax.sharding.Mesh`` + ``shard_map`` data parallelism over reads in
  place of the reference's thread pool (``libms/src/threading/``).
"""

__version__ = "0.1.0"

from muchsalsa_tpu.config import Config

__all__ = ["Config", "__version__"]
