"""Task and distillation losses (PyTorch): the distiller zoo, SupCon."""
from .distiller_zoo import (VIDHead, ab_loss, attention_loss, correlation_loss,
                            factor_transfer_loss, feats_kl, fsp_loss,
                            hint_loss, kdsvd_loss, nst_loss, pkt_loss,
                            rkd_loss)
from .kd import distill_kl, pred_kd_loss, sp_loss
from .orth import orth_loss
from .supcon import supcon_loss
from .task import cox_loss, l1_regularizer, nll_loss
