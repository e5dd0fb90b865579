"""lux_tpu_torch: the PyTorch/CUDA port of lux_tpu.

The module layout mirrors ``lux_tpu`` so each counterpart is easy to find:
``graph`` (host CSC graph, RMAT, ``.lux`` files, padded pull shards),
``ops`` (segmented reductions, the block-CSR SpMVs and the routed pull,
with their hand-written CUDA kernels under ``csrc/``), ``program`` (the
declarative vertex-program language), ``engine`` (the pull engine),
``models`` (PageRank, collaborative filtering) and ``apps`` (the CLIs).

Host-side graph code is numpy; device code is torch.  Entry points take
an explicit ``device`` and default to ``"cuda"``; they run on the CPU
only when the caller asks for it.  Nothing here imports jax or lux_tpu.
Importing this package imports no torch extension and builds nothing:
the CUDA kernels are compiled with ``nvcc`` at their first launch.
"""
