"""CRD memory banks and the NCE contrast loss (PyTorch); the CLAT
student's v10 (kNN and k-means positives); HKD's banks, kNN graph and
TAGConv."""
from .crd import (CRDBank, Embed, bank_update, contrast_loss,
                  crd_gate_weights, crd_scores, crd_scores_select, draw_pick,
                  init_bank, set_z, weighted_contrast_loss)
from .crd_v10 import (assign_sample_weights, class_centers,
                      contrast_loss_v10, crd_v10_scores, draw_gumbel,
                      masked_kmeans)
from .hkd import (HKDBank, TAGEncoder, hkd_bank_update, hkd_graph_scores,
                  hkd_scores, init_hkd_bank, knn_adjacency, nce_softmax_loss)
