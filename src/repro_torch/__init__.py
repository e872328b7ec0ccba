"""repro_torch: SLUGGER lossless hierarchical graph summarization — the
PyTorch/CUDA port of the `repro` package.

Host integer planning stays in NumPy; the device work runs as hand-written
CUDA kernels for Hopper (``csrc/``) on a ``torch.device``. Entry points run
on the CUDA card unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.

The four entry points below resolve on first access (PEP 562), so that
importing a stdlib-only subpackage (`repro_torch.analysis`, the linter)
loads neither torch nor numpy.
"""
import importlib

_LAZY = {"summarize": "repro_torch.core.slugger",
         "SluggerState": "repro_torch.core.slugger",
         "Summary": "repro_torch.core.summary",
         "SummarizerEngine": "repro_torch.core.engine"}

__all__ = ["summarize", "Summary", "SummarizerEngine", "SluggerState"]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
