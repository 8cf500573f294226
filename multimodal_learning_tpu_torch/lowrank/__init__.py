"""The M3LR low-rank (t-SVD) constraint, PyTorch."""
from .tsvt import tensor_nuclear_norm, update_aux
from .views import build_view_features, update_adj_tensor
