"""The port's failure-mode rules (counterparts of the reference's
``repro.analysis.rules.jax_rules``).

Every rule here maps to a bug class this codebase has a concrete
mechanism for:

* **Stale caches.**  ``PackedConv.tuned``/``packed``, the ``wl_cache`` /
  ``_fwd_cache`` dicts, ``BlockSparseMatrix.indices_np`` and a work list's
  device copies (``WorkList._device``, the ``DeviceSchedule`` the walker
  reads, and ``WorkList._live``) are keyed on the packing they came from;
  mutating them outside the invalidating setters leaves the forward's
  closures, or the kernels, reading the old packing (``CACHE-MUTATE``).
* **Host schedule builds under graph capture.**  ``build_worklist`` is
  host numpy by design (§3.2 telescoping needs concrete indices and
  occupancy); a function that reaches it during CUDA-graph capture records
  a graph that replays one batch's schedule for every later batch. Such a
  function must refuse capture with a clear error first
  (``torch.cuda.is_current_stream_capturing()``, as ``ops._worklist_for``
  does), the counterpart of the reference's leaked-tracer guard
  (``EAGER-GUARD``).
* **TF32.**  The port's gate is rel err <= 1e-5 against fp32 oracles;
  ``allow_tf32 = True`` or a matmul precision other than ``"highest"``
  lets cuBLAS/cuDNN round operands to 10-bit mantissas and breaks it
  (``TF32-ON``).
* **Silent slow paths.**  A kernel wrapper runs its ``*_plain`` version
  only for a CPU tensor; one that reaches it on another branch, or from an
  ``except`` handler, turns a failed launch into a 10–100x slower answer
  nobody asked for, the counterpart of the reference's frozen-interpret
  rule (``KERNEL-FALLBACK``).
* **Host reads in captured bodies.**  A function the port captures in a
  CUDA graph (marked ``@graphs.captured``) runs on the card at every
  replay, its Python only once: a host read in it (``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``int()``/``float()``/
  ``bool()`` of a tensor) fails the capture, and a tensor built from host
  values (``torch.tensor(..., device=...)``) would freeze the capture's
  values into every replay (``GRAPH-HOST-READ``, the counterpart of the
  reference's ``HOST-TRACED-NP``).
* **Silent suppressions.**  A suppression comment must say why
  (``LINT-SUPPRESS``).

The reference's ``PL-INTERP-*``/``PL-NO-INTERPRET`` and
``JIT-STATIC-NONHASH`` have no counterpart: the port has no Pallas, no
``interpret`` switch and no jit static arguments.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.analysis.diagnostics import (Diagnostic, Severity, diag,
                                              register)

E, W = Severity.ERROR, Severity.WARNING

register("CACHE-MUTATE", E, "cache a forward or a kernel reads (tuned/"
         "packed/wl_cache/_fwd_cache/indices_np/_device/_live) mutated "
         "outside the invalidating setters", "ci")
register("EAGER-GUARD", E, "host schedule build reachable without a "
         "CUDA-graph capture guard", "ci")
register("TF32-ON", E, "TF32 switched on (allow_tf32 = True, or a matmul "
         "precision other than 'highest') under the 1e-5 gate", "ci")
register("KERNEL-FALLBACK", E, "kernel wrapper reaches its plain version "
         "off the CPU-tensor branch (silent slow path)", "ci")
register("GRAPH-HOST-READ", E, "host read (.item()/.cpu()/.tolist()/"
         ".numpy(), int()/float()/bool() of a tensor) or host-built device "
         "tensor inside a function captured in a CUDA graph", "ci")
register("LINT-SUPPRESS", W, "suppression comment without a justifying "
         "reason", "ci")

#: Modules allowed to write the caches: the invalidating setters and the
#: owners of each cache.  Matched as path suffixes.
CACHE_WRITER_ALLOWLIST = (
    "kernels/autotune.py",    # autotune_conv/autotune_model invalidate
    "core/bitmask.py",        # host_indices() materializes its own copy
    "vision/model.py",        # compile_forward owns _fwd_cache
    "kernels/worklist_core.py",  # a WorkList owns its device copies
)

#: Dict-valued caches: subscript-assign / del / .clear() / .pop() ... are
#: writes.
CACHE_DICTS = ("wl_cache", "_fwd_cache", "_device", "_live")
#: Attributes whose assignment re-keys or must invalidate a cache.
CACHE_ATTRS = ("tuned", "packed", "indices_np") + CACHE_DICTS
_DICT_WRITES = ("clear", "pop", "popitem", "setdefault", "update")

#: Host-side schedule functions (eager-only by design).
EAGER_SCHEDULES = ("build_worklist",)
#: The capture query a guard calls.
CAPTURE_GUARDS = ("is_current_stream_capturing",)

#: The decorator that marks a body ``graphs.CapturedGraph`` captures.
CAPTURE_MARK = "captured"
#: Tensor methods that copy to the host (and synchronise).
HOST_READS = ("item", "cpu", "tolist", "numpy")
#: Python casts that read a tensor's value to the host.
HOST_CASTS = ("int", "float", "bool")
#: Tensor attributes that are host metadata, not values.
TENSOR_META = ("shape", "ndim", "dim", "size", "numel", "dtype", "device",
               "is_cuda", "element_size", "stride")


@dataclasses.dataclass
class FileContext:
    """Per-file lint state: path, source, and suppression table."""
    path: str                 # repo-relative, for diagnostics
    source: str
    suppressions: Dict[int, Set[str]] = dataclasses.field(
        default_factory=dict)  # line -> rule ids ("*" = all)
    bad_suppressions: List[int] = dataclasses.field(default_factory=list)

    def suppressed(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            ids = self.suppressions.get(ln)
            if ids and (rule in ids or "*" in ids):
                return True
        return False


def _fdiag(rule: str, ctx: FileContext, node: ast.AST, message: str, *,
           hint: str) -> Optional[Diagnostic]:
    line = getattr(node, "lineno", 1)
    if ctx.suppressed(rule, line):
        return None
    return diag(rule, f"{ctx.path}:{line}", message, hint=hint)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name: torch.cuda.foo -> 'torch.cuda.foo'."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _walk_functions(tree: ast.Module):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _params(fn: ast.FunctionDef) -> List[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
def rule_cache_mutate(tree: ast.Module, ctx: FileContext
                      ) -> List[Diagnostic]:
    """CACHE-MUTATE: writes to the caches outside the allowlisted
    invalidating setters."""
    if any(ctx.path.endswith(sfx) for sfx in CACHE_WRITER_ALLOWLIST):
        return []
    out: List[Diagnostic] = []

    def flag(node, what):
        d = _fdiag(
            "CACHE-MUTATE", ctx, node,
            f"{what} outside the invalidating setters",
            hint="route through autotune_conv/autotune_model (they clear "
                 "the dependent caches), repack the artifact, or build a "
                 "new work list")
        if d:
            out.append(d)

    def check_target(node, t):
        if isinstance(t, ast.Attribute) and t.attr in CACHE_ATTRS:
            flag(node, f"assignment to .{t.attr}")
        if isinstance(t, ast.Subscript) and \
                isinstance(t.value, ast.Attribute) and \
                t.value.attr in CACHE_DICTS:
            flag(node, f"write into .{t.value.attr}[...]")

    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                check_target(node, t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            check_target(node, node.target)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                check_target(node, t)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _DICT_WRITES:
            owner = node.func.value
            if isinstance(owner, ast.Attribute) and \
                    owner.attr in CACHE_DICTS:
                flag(node, f".{owner.attr}.{node.func.attr}()")
    return out


def rule_eager_guard(tree: ast.Module, ctx: FileContext
                     ) -> List[Diagnostic]:
    """EAGER-GUARD: a function with parameters that calls a host schedule
    function must ask ``torch.cuda.is_current_stream_capturing()`` (and
    refuse capture) in its own body. The finding anchors at the function:
    it is the function that lacks the guard."""
    out: List[Diagnostic] = []
    for fn in _walk_functions(tree):
        if not _params(fn) or fn.name in EAGER_SCHEDULES:
            continue
        build = None
        guarded = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func).split(".")[-1]
            if name in EAGER_SCHEDULES:
                build = name
            elif name in CAPTURE_GUARDS:
                guarded = True
        if build is None or guarded:
            continue
        d = _fdiag(
            "EAGER-GUARD", ctx, fn,
            f"{fn.name}() calls {build}() with no CUDA-graph capture "
            f"guard — a captured graph would replay one batch's host "
            f"schedule",
            hint="raise a clear error when "
                 "torch.cuda.is_current_stream_capturing() (see "
                 "ops._worklist_for), or build the schedule at pack time")
        if d:
            out.append(d)
    return out


def _tf32_value_ok(attr: str, value: ast.AST) -> bool:
    if not isinstance(value, ast.Constant):
        return False
    if attr == "allow_tf32":
        return value.value is False
    return value.value == "ieee"            # fp32_precision


def rule_tf32_on(tree: ast.Module, ctx: FileContext) -> List[Diagnostic]:
    """TF32-ON: ``*.allow_tf32 = <anything but False>``,
    ``*.fp32_precision = <anything but "ieee">`` and
    ``set_float32_matmul_precision(<anything but "highest">)``."""
    out: List[Diagnostic] = []
    hint = ("keep TF32 off: the kernels' and oracles' fp32 sums are held "
            "to rel err 1e-5")
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and \
                        t.attr in ("allow_tf32", "fp32_precision") and \
                        not _tf32_value_ok(t.attr, node.value):
                    d = _fdiag("TF32-ON", ctx, node,
                               f".{t.attr} set to something other than "
                               f"fp32", hint=hint)
                    if d:
                        out.append(d)
        elif isinstance(node, ast.Call) and _dotted(node.func).endswith(
                "set_float32_matmul_precision"):
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and
                    arg.value == "highest"):
                d = _fdiag("TF32-ON", ctx, node,
                           "set_float32_matmul_precision() other than "
                           "'highest' lets matmuls run in TF32", hint=hint)
                if d:
                    out.append(d)
    return out


def _cpu_test(test: ast.AST) -> Optional[bool]:
    """True for ``<x>.device.type == "cpu"`` / ``<x>.is_cpu`` (the CPU
    branch is the body), False for ``<x>.device.type != "cpu"`` (the CPU
    branch is the ``else``), None for any other test."""
    if isinstance(test, ast.Attribute) and test.attr == "is_cpu":
        return True
    if isinstance(test, ast.Compare) and len(test.ops) == 1:
        sides = (test.left, test.comparators[0])
        if any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides) and \
                any(isinstance(s, ast.Attribute) and s.attr == "type"
                    for s in sides):
            if isinstance(test.ops[0], ast.Eq):
                return True
            if isinstance(test.ops[0], ast.NotEq):
                return False
    return None


def rule_kernel_fallback(tree: ast.Module, ctx: FileContext
                         ) -> List[Diagnostic]:
    """KERNEL-FALLBACK: in ``kernels/``, a call of a ``*_plain`` function
    from a function that is not itself a plain version must sit in the
    CPU-tensor branch of an ``if`` (or conditional expression), and not
    under an ``except`` handler."""
    if "/kernels/" not in "/" + ctx.path.replace("\\", "/"):
        return []
    out: List[Diagnostic] = []

    def visit(node, on_cpu: bool, in_except: bool, fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            if isinstance(node, ast.Lambda) or \
                    not node.name.endswith("_plain"):
                for child in ast.iter_child_nodes(node):
                    visit(child, False, False,
                          node if not isinstance(node, ast.Lambda) else fn)
            return
        if isinstance(node, ast.Call) and fn is not None:
            name = _dotted(node.func).split(".")[-1]
            if name.endswith("_plain") and (in_except or not on_cpu):
                where = "an except handler" if in_except else \
                    "a branch other than the CPU-tensor one"
                d = _fdiag(
                    "KERNEL-FALLBACK", ctx, node,
                    f"{fn.name}() reaches {name}() from {where}",
                    hint="run the plain version only under "
                         "`if x.device.type == \"cpu\"`; on a CUDA tensor "
                         "launch the kernel or raise")
                if d:
                    out.append(d)
        if isinstance(node, (ast.If, ast.IfExp)):
            cpu = _cpu_test(node.test)
            visit(node.test, on_cpu, in_except, fn)
            body = node.body if isinstance(node.body, list) else [node.body]
            orelse = node.orelse if isinstance(node.orelse, list) \
                else [node.orelse]
            for child in body:
                visit(child, on_cpu or cpu is True, in_except, fn)
            for child in orelse:
                visit(child, on_cpu or cpu is False, in_except, fn)
            return
        if isinstance(node, ast.ExceptHandler):
            for child in ast.iter_child_nodes(node):
                visit(child, on_cpu, True, fn)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, on_cpu, in_except, fn)

    visit(tree, False, False, None)
    return out


def _captured(fn: ast.FunctionDef) -> bool:
    return any(_dotted(d.func if isinstance(d, ast.Call) else d)
               .split(".")[-1] == CAPTURE_MARK for d in fn.decorator_list)


def _tensor_value(node: ast.AST, names: Set[str]) -> bool:
    """Whether ``node`` reads the value of one of ``names`` (a parameter
    of a captured body, best taken for a tensor): the name itself, a
    subscript, an arithmetic expression or a method call on it, but not its
    host metadata (``x.shape[0]``, ``x.size(1)``)."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Subscript):
        return _tensor_value(node.value, names)
    if isinstance(node, ast.BinOp):
        return _tensor_value(node.left, names) or \
            _tensor_value(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return _tensor_value(node.operand, names)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr not in TENSOR_META and \
            _tensor_value(node.func.value, names)
    return False


def rule_graph_host_read(tree: ast.Module, ctx: FileContext
                         ) -> List[Diagnostic]:
    """GRAPH-HOST-READ: inside a function marked ``@captured`` (and the
    functions nested in it), ``.item()``/``.cpu()``/``.tolist()``/
    ``.numpy()`` on anything, ``int()``/``float()``/``bool()`` of a
    parameter's value, and ``torch.tensor``/``torch.as_tensor`` with a
    ``device=`` (host values copied at capture, replayed frozen)."""
    out: List[Diagnostic] = []
    hint = ("keep the value on the card (a static input buffer of the "
            "graph), or do the host work before the capture")
    for fn in _walk_functions(tree):
        if not _captured(fn):
            continue
        names: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                names.update(a.arg for a in _params(node))
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = _dotted(node.func)
            bad = None
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr in HOST_READS:
                bad = f".{node.func.attr}()"
            elif callee in HOST_CASTS and node.args and \
                    _tensor_value(node.args[0], names):
                bad = f"{callee}() of a tensor"
            elif callee.split(".")[-1] in ("tensor", "as_tensor") and \
                    callee.startswith("torch.") and \
                    any(k.arg == "device" for k in node.keywords):
                bad = f"{callee}(..., device=...) from host values"
            if bad:
                d = _fdiag(
                    "GRAPH-HOST-READ", ctx, node,
                    f"{bad} inside {fn.name}(), which a CUDA graph "
                    f"captures: the capture fails or replays a frozen "
                    f"value", hint=hint)
                if d:
                    out.append(d)
    return out


ALL_RULES: Sequence[Callable[[ast.Module, FileContext], List[Diagnostic]]] \
    = (
        rule_cache_mutate,
        rule_eager_guard,
        rule_tf32_on,
        rule_kernel_fallback,
        rule_graph_host_read,
    )
