"""Embedding visualisation (JAX counterpart deeplearning4j_tpu/plot;
reference deeplearning4j-core `org/deeplearning4j/plot/`: Tsne.java,
BarnesHutTsne.java, PlotFilters.java).

Exact t-SNE runs on the card (all-pairs affinities are dense [N, N]
work); Barnes-Hut t-SNE uses the host-side SpTree for its O(N log N)
force approximation, as in the JAX package and the reference; the
filter plots (filters.py) are numpy on the host.
"""

from deeplearning4j_tpu_torch.plot.barnes_hut_tsne import (  # noqa: F401
    BarnesHutTsne,
)
from deeplearning4j_tpu_torch.plot.tsne import Tsne  # noqa: F401

__all__ = ["Tsne", "BarnesHutTsne"]
