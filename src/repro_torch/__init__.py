"""PyTorch + CUDA port of the BARISTA sparse inference paths.

Mirrors the module layout of ``repro`` (the JAX/Pallas reference) for two
paths. Sparse CNN inference: pack pruned filters into chunk-block-sparse
tiles (``core.bitmask``, ``sparsity``), compact each layer into the
telescoped work list (``kernels.worklist_core``), run every conv layer as
an implicit GEMM (``kernels.sparse_conv``), check the whole net against
its dense oracle and serve image batches (``vision``). Sparse LM serving:
pack every FFN (``sparsity.sparse_ffn``), run the decoder (``models``)
with each FFN as the fused in/gate/activation kernel and the two-sided
output projection (``kernels.fused_ffn``, ``kernels.bitmask_spmm``), and
serve requests by continuous batching (``serve``).

The four kernels on those paths are hand-written CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use. Every wrapper runs the
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor.
Nothing here imports JAX or the reference package.
"""
