from repro_torch.graphs.csr import Graph
from repro_torch.graphs import generators

__all__ = ["Graph", "generators"]
