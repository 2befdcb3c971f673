"""The sparse GEMM kernels of the conv path: the work-list walker
(``worklist_core``) and the dense-grid predicated conv (``sparse_conv``),
each a CUDA C++ kernel for Hopper (``csrc/``) beside its plain version."""
