from repro_torch.graphs.csr import Graph
from repro_torch.graphs.partitioned import (GraphShard, PartitionedGraph,
                                            as_partitioned, block_owner)
from repro_torch.graphs import generators, datasets

__all__ = ["Graph", "PartitionedGraph", "GraphShard", "as_partitioned",
           "block_owner", "generators", "datasets"]
