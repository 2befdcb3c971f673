"""The hand-written kernels and their wrappers: the work-list walker
(``worklist_core``) and the dense-grid predicated conv (``sparse_conv``) of
the conv path, the predicated sparse matmul (``bitmask_spmm``) and the
fused FFN in-projection (``fused_ffn``) of the LM FFN path, with the FFN
entry points in ``ops``. Each kernel is CUDA C++ for Hopper (``csrc/``)
beside its plain PyTorch version."""
