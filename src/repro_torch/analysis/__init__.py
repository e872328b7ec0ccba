"""`repro_torch.analysis` — the port's invariant linter (DESIGN.md §10).

The port's guarantees — summaries bit-identical across its backends and to
the reference's, plan-replay determinism, the resident path's transfer
accounting, kernels reached by name through ctypes — rest on the coding
contracts `repro.analysis` names for the JAX package. This package holds
the port to the same contracts, in PyTorch's idiom:

* `repro_torch.analysis.core`     — the rule engine (the reference's,
  kept as the port's own copy): `Finding`, `Rule`, inline
  ``# lint: disable=RULE -- reason`` suppressions, module walking.
* `repro_torch.analysis.rules`    — ten rules scoped to `src/repro_torch/`
  and the measuring tools at the root; KERNEL-TRIPLE also holds the
  ctypes launchers (`kernels/_build.py`) to the ``extern "C"``
  definitions in `csrc/*.cu`.
* `repro_torch.analysis.baseline` — the port's own grandfather list
  (``baseline.json``): intentional exemptions, each with a written
  justification; stale entries are themselves an error.
* `repro_torch.analysis.lint`     — the CLI:
  ``python -m repro_torch.analysis.lint`` exits nonzero on any NEW
  violation.

No dependencies beyond the stdlib, and nothing of torch, numpy, jax or
`repro`: the linter runs before any of them is importable (the package's
``__init__`` resolves its engine lazily for the same reason).
"""
from repro_torch.analysis.core import Finding, Rule, TreeRule, lint_paths, lint_source
from repro_torch.analysis.rules import RULES, rules_by_name

__all__ = ["Finding", "Rule", "TreeRule", "RULES", "rules_by_name",
           "lint_paths", "lint_source"]
