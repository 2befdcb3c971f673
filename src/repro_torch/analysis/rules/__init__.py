"""AST lint rules of the port.

Each rule is a function ``(module: ast.Module, ctx: FileContext) ->
List[Diagnostic]`` registered in :data:`ALL_RULES`.  Rules encode the
port's *known* failure modes — each one is a bug class that has a concrete
mechanism here (stale caches the kernels read, host builds under graph
capture, TF32 under a 1e-5 gate, silent slow paths), not a style
preference.
"""
from repro_torch.analysis.rules.torch_rules import ALL_RULES, FileContext

__all__ = ["ALL_RULES", "FileContext"]
