"""Task and distillation losses (PyTorch)."""
from .kd import distill_kl, pred_kd_loss, sp_loss
from .orth import orth_loss
from .task import cox_loss, l1_regularizer, nll_loss
