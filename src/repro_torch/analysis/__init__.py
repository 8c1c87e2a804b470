"""Static analysis of the port: contracts over recorded steps, and lints.

Two halves, as in the JAX package's ``repro/analysis``:

* :mod:`repro_torch.analysis.contracts` / :mod:`repro_torch.analysis.matrix`
  hold the collectives a step issues (``core/collectives.py``'s
  recorder), the buffers it updates in place and the programs it builds
  to contracts;
* :mod:`repro_torch.analysis.lint` is the stdlib-``ast`` lints (host
  syncs on the step path, f32 accumulators, thread discipline), which
  import no torch.

``python -m repro_torch.analysis`` runs both.  The namespace stays
import-light: import the submodules directly, or use the lazy attribute
access below.
"""

from __future__ import annotations

_SUBMODULES = ("contracts", "lint", "matrix")

__all__ = list(_SUBMODULES)


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(
        f"module 'repro_torch.analysis' has no attribute {name!r}")
