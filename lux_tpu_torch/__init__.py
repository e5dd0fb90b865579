"""lux_tpu_torch: the PyTorch/CUDA port of lux_tpu.

The module layout mirrors ``lux_tpu`` so each counterpart is easy to find:
``graph`` (host CSC graph, RMAT, ``.lux`` files, padded pull shards),
``ops`` (segmented reductions, with the block-CSR SpMV and the segmented
scan as hand-written CUDA kernels under ``csrc/``), ``program`` (the
declarative vertex-program language), ``engine`` (the pull engine),
``models`` (PageRank) and ``apps`` (the CLI).

Host-side graph code is numpy; device code is torch.  Entry points take
an explicit ``device`` and default to ``"cuda"``; they run on the CPU
only when the caller asks for it.  Nothing here imports jax or lux_tpu.
Importing this package imports no torch extension and builds nothing:
the CUDA kernels are compiled with ``nvcc`` at their first launch.
"""
