"""DeeperGCN at the widths of OGB's ogbn-products leaderboard entry "DeeperGCN".

Li, Xiong, Thabet, Ghanem, DeeperGCN: All You Need to Train Deeper GCNs,
arXiv:2006.07739, as the authors' ``lightaime/deep_gcns_torch``
(``examples/ogb/ogbn_products``) builds it for that entry: 14 ``GENConv``
layers of width 128 in pre-activation residual ("res+") blocks, the
softmax aggregator at a fixed t, one Linear a layer's MLP, a norm before
every layer but the first and before the head, on ogbn-products' 100 input
features and 47 classes. With eps = 1e-7, for vertex i and channel c:

    h^0       = x W_enc + b_enc                                   (N, 100) -> (N, 128)
    GENConv_l(u)_i = (u_i + m_i) W_l + b_l,
        m_ic = sum_{j in N_in(i) + {i}} softmax_j(t q_jc) q_jc,  q_j = ReLU(u_j) + eps
    h^1       = GENConv_0(h^0)
    h^{l+1}   = h^l + GENConv_l(ReLU(BN_{l-1}(h^l)))              l = 1 .. 13
    logits    = ReLU(BN_13(h^14)) W_out + b_out                   (N, 128) -> (N, 47)

with BN in eval mode, gamma (h - mu) / sqrt(sigma^2 + bn_eps) + beta, and
128 softmaxes a vertex (one a channel). For inference the authors'
``softmax_sg`` is the softmax: its stop-gradient acts on training alone.

Parameters: 253,743, the count the leaderboard lists. The encoder 100 ->
128 has 12,928; each of the 14 layers a Linear 128 -> 128 (16,512) and a
norm's gamma and beta (256); the head 128 -> 47 has 6,063: 12,928 + 14 ×
16,768 + 6,063. t is fixed and is no parameter, and the norms' running
means and variances are buffers. The same count at 28 layers, 128 inputs and
40 classes gives the ogbn-arxiv entry's 491,176.

Assumed, from the authors' README for ogbn-products rather than read from
the leaderboard: t = 0.1 (``--t 0.1``), the self loop (``--self_loop``) and
BatchNorm (the count is the same with LayerNorm).

Departures from the leaderboard's training script: no dropout (inference
only), and the logits are the model's output, before its ``log_softmax``.
The deployment it stands for is OGB's full-graph inference, which scores
every node with all of its in-neighbours and a self loop.

Not registered: the port's registry and ``GNNConfig`` are held equal to
the JAX package's, which has no DeeperGCN. ``nn.gnn`` runs it as kind
``"deepergcn"``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeeperGCNConfig:
    name: str = "deepergcn-ogbn-products"
    kind: str = "deepergcn"
    n_layers: int = 14
    d_hidden: int = 128
    d_out: int = 47
    t: float = 0.1           # the softmax aggregator's inverse temperature, fixed
    eps: float = 1e-7        # added to every message, ReLU(u) + eps
    bn_eps: float = 1e-5     # BatchNorm's

    @property
    def family(self) -> str:
        return "gnn"


CONFIG = DeeperGCNConfig()
