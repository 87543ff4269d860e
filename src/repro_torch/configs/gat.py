"""GAT at the widths of OGB's ogbn-products leaderboard entry "GAT w/NS".

Veličković et al., Graph Attention Networks, ICLR 2018, arXiv:1710.10903,
as PyG's ``examples/ogbn_products_gat.py`` builds it for that entry: three
``GATConv`` layers of 4 heads, 128 channels a head concatenated (512) on
layers 1-2 and 4 heads of 47 channels averaged on the last (ogbn-products
has 47 classes), a linear skip with a bias on every layer (100 -> 512,
512 -> 512, 512 -> 47), ELU between layers, LeakyReLU slope 0.2 in the
scores and PyG's default self loops, on 100 input features: 751,574
parameters, the count the leaderboard lists.

Layer l, head k, vertex i:

    z = h @ W_l                                      (no bias)
    s_src[v, k] = <z[v, k, :], a_src[k]>,  s_dst[v, k] = <z[v, k, :], a_dst[k]>
    e_ijk = LeakyReLU_0.2(s_src[j, k] + s_dst[i, k])  for j in N_in(i) + {i}
    alpha_ijk = softmax over j of e_ijk
    o[i, k, :] = sum_j alpha_ijk * z[j, k, :]
    h' = concat_k o (layers 1-2) or mean_k o (the last) + bias + h @ W_skip + b_skip
    then ELU on layers 1-2.

Departures from the leaderboard's training script: no dropout (inference
only), and the logits are the model's output, before its ``log_softmax``.
The deployment it stands for is OGB's layer-wise full-graph inference,
which scores every node with all of its in-neighbours.

Not registered: the port's registry and ``GNNConfig`` are held equal to
the JAX package's, which has no GAT. ``nn.gnn`` runs it as kind ``"gat"``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-ogbn-products"
    kind: str = "gat"
    n_layers: int = 3
    heads: int = 4
    d_head: int = 128        # channels a head on the layers before the last
    d_out: int = 47          # channels a head on the last layer (the classes)
    negative_slope: float = 0.2
    self_loops: bool = True
    grasp: bool = True       # gather rows through the L2 hot tier (make_plan's rows)

    @property
    def family(self) -> str:
        return "gnn"


CONFIG = GATConfig()
