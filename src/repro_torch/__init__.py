"""PyTorch + CUDA port of the BARISTA sparse CNN inference path.

Mirrors the module layout of ``repro`` (the JAX/Pallas reference) for the
paper's main workload: pack pruned filters into chunk-block-sparse tiles
(``core.bitmask``, ``sparsity``), compact each layer into the telescoped
work list (``kernels.worklist_core``), run every conv layer as an implicit
GEMM (``kernels.sparse_conv``), check the whole net against its dense oracle
and serve image batches (``vision``).

The two kernels on that path are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use. Every wrapper runs the
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor.
Nothing here imports JAX or the reference package.
"""
