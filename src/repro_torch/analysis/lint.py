"""CI gate of the port: AST lint over its source + artifact verification
over the pruned model zoo.

    PYTHONPATH=src python -m repro_torch.analysis.lint          # both halves
    PYTHONPATH=src python -m repro_torch.analysis.lint --ast-only
    PYTHONPATH=src python -m repro_torch.analysis.lint --artifacts-only
    PYTHONPATH=src python -m repro_torch.analysis.lint --rules  # registry
    PYTHONPATH=src python -m repro_torch.analysis.lint --format github \\
        >> "$GITHUB_STEP_SUMMARY"

Run from the root of the checkout. Exits non-zero iff any finding is an
error. The AST pass walks ``src/repro_torch`` and ``chip_smoke.py``. The
zoo sweep builds every architecture at both pruning patterns on the CPU,
verifies the packed chain (``deep=True``) off the card and under the card
rules (host arithmetic: no card needed), then autotunes (cost model only
— no measurement) and re-verifies so the tuned-config contract is
exercised too. ``--layers`` bounds the depth per network so the job stays
fast; the full-depth sweep is the same command with ``--layers 0``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Sequence

from repro_torch.analysis.astlint import lint_tree
from repro_torch.analysis.diagnostics import (REGISTRY, Diagnostic,
                                              has_errors, render_github,
                                              render_text)

#: The zoo × pattern sweep the CI gate verifies.
ZOO = ("AlexNet", "VGGNet", "ResNet18", "ResNet50")
PATTERNS = ("unstructured", "chunk")
#: What the AST pass walks, relative to the checkout's root.
LINT_PATHS = ("src/repro_torch", "chip_smoke.py")


def verify_zoo(layers: int = 3, density: float = 0.3,
               verbose: bool = False) -> List[Diagnostic]:
    """Build + verify every (arch, pattern) twice: freshly packed, then
    cost-model autotuned (tuned-config contract, wl_cache invalidation);
    each off the card and under the card rules."""
    from repro_torch.analysis.verify import verify_model
    from repro_torch.kernels.autotune import autotune_model
    from repro_torch.vision.model import build_vision_model

    out: List[Diagnostic] = []
    for name in ZOO:
        for pattern in PATTERNS:
            t0 = time.time()
            vm = build_vision_model(
                name, density=density, seed=0,
                num_layers=layers if layers > 0 else None,
                pattern=pattern, device="cpu")
            for tag in ("default", "tuned"):
                if tag == "tuned":
                    autotune_model(vm, batch=1, measure=False)
                for device, where in ((None, ""), ("cuda", "/card")):
                    out.extend(verify_model(
                        vm, f"zoo/{name}/{pattern}/{tag}{where}", deep=True,
                        device=device))
            if verbose:
                print(f"  {name}/{pattern}: {time.time() - t0:.1f}s",
                      file=sys.stderr)
    return out


def lint_paths(paths: Sequence[str],
               repo_root: str = ".") -> List[Diagnostic]:
    """The AST pass over each directory or file of ``paths``."""
    out: List[Diagnostic] = []
    for path in paths:
        out.extend(lint_tree(path, repo_root))
    return out


def render_rules() -> str:
    lines = ["| rule | severity | runs at | proves |",
             "| --- | --- | --- | --- |"]
    for info in REGISTRY.values():
        lines.append(f"| `{info.rule}` | {info.severity} | {info.stage} "
                     f"| {info.summary} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ast-only", action="store_true",
                    help="skip the zoo artifact sweep")
    ap.add_argument("--artifacts-only", action="store_true",
                    help="skip the AST pass")
    ap.add_argument("--src", nargs="+", default=list(LINT_PATHS),
                    help="directories and files the AST pass walks "
                         "(default: src/repro_torch chip_smoke.py)")
    ap.add_argument("--layers", type=int, default=3,
                    help="layers per zoo network (0 = full depth; "
                         "default 3 keeps CI fast)")
    ap.add_argument("--density", type=float, default=0.3)
    ap.add_argument("--format", choices=("text", "github"), default="text")
    ap.add_argument("--rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.rules:
        # the verifier registers its rules at import
        import repro_torch.analysis.verify  # noqa: F401
        print(render_rules())
        return 0

    diags: List[Diagnostic] = []
    if not args.artifacts_only:
        diags.extend(lint_paths(args.src, "."))
    if not args.ast_only:
        diags.extend(verify_zoo(args.layers, args.density, args.verbose))

    render = render_github if args.format == "github" else render_text
    print(render(diags))
    return 1 if has_errors(diags) else 0


if __name__ == "__main__":
    sys.exit(main())
