from stgcn_tpu_torch.graph import skeleton
from stgcn_tpu_torch.graph.adjacency import (
    NormalizationMode,
    Strategy,
    create_adjacency_matrices,
    get_normalized_adjacency,
    normalize,
    num_partitions,
)
