"""CRD memory banks and the NCE contrast loss (PyTorch)."""
from .crd import (CRDBank, Embed, bank_update, contrast_loss,
                  crd_gate_weights, crd_scores, crd_scores_select, init_bank,
                  set_z, weighted_contrast_loss)
