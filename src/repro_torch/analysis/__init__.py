"""Static-analysis subsystem (port of ``repro.analysis``): artifact
verifier + the port's own AST lint.

Two halves, one diagnostics vocabulary:

* :mod:`repro_torch.analysis.verify` — a checker over the port's packed
  artifacts (:class:`~repro_torch.kernels.worklist_core.WorkList` and its
  device copies, :class:`~repro_torch.core.bitmask.BlockSparseMatrix`,
  :class:`~repro_torch.sparsity.conv.PackedConv`, the ``sparsify_model``
  FFN leaves) proving the §3.2–§4 structural invariants the kernels assume
  — no dead steps scheduled, pair-major flat schedules, true permutation
  folds, bitmask ↔ value consistency, fresh work-list caches, tuned
  configs whose launches the card takes — and returning structured
  diagnostics instead of asserting. It launches no kernel: index arrays
  come to the host, value checks are reductions on the tensors' device.
* :mod:`repro_torch.analysis.astlint` (+
  :mod:`repro_torch.analysis.rules`) — an ``ast`` pass over the port's
  source catching its known failure modes (cache mutation outside the
  invalidating setters, host schedule builds reachable under CUDA-graph
  capture, TF32 switched on, a kernel wrapper reaching its plain version
  off the CPU branch).

Both run from ``python -m repro_torch.analysis.lint``, and the verifier
is wired into pack time (``build_sparse_chain``/``build_sparse_graph``/
``sparsify_model`` ``strict=``) and admission
(:class:`~repro_torch.vision.engine.VisionEngine`,
:class:`~repro_torch.serve.vision.VisionServer`,
:class:`~repro_torch.serve.scheduler.Scheduler`), on by default.
"""
from repro_torch.analysis.diagnostics import (AnalysisError, Diagnostic,
                                              Severity, has_errors,
                                              raise_on_errors, render_github,
                                              render_text)
from repro_torch.analysis.verify import (SMEM_BUDGET_BYTES, verify_artifact,
                                         verify_block_sparse, verify_chain,
                                         verify_combined_schedule,
                                         verify_ffn_leaves, verify_graph,
                                         verify_model, verify_packed_conv,
                                         verify_param_leaves,
                                         verify_sparse_ffn, verify_worklist)

__all__ = [
    "AnalysisError", "Diagnostic", "SMEM_BUDGET_BYTES", "Severity",
    "has_errors", "raise_on_errors", "render_github", "render_text",
    "verify_artifact", "verify_block_sparse", "verify_chain",
    "verify_combined_schedule", "verify_ffn_leaves", "verify_graph",
    "verify_model",
    "verify_packed_conv", "verify_param_leaves", "verify_sparse_ffn",
    "verify_worklist",
]
