"""repro_torch: SLUGGER lossless hierarchical graph summarization — the
PyTorch/CUDA port of the `repro` package.

Host integer planning stays in NumPy; the device work runs as hand-written
CUDA kernels for Hopper (``csrc/``) on a ``torch.device``. Entry points run
on the CUDA card unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions.
"""
from repro_torch.core.engine import SummarizerEngine
from repro_torch.core.slugger import SluggerState, summarize
from repro_torch.core.summary import Summary

__all__ = ["summarize", "Summary", "SummarizerEngine", "SluggerState"]
