"""Gradient-guided teacher weighting (GK-Refine / AEKD / GKM) and the
one-class-SVM weighting, PyTorch."""
from .aekd import (aekd_scale, aekd_total, aekd_v2_gate, feature_grads,
                   gk_refine_param_space, gk_refine_thresh_weights,
                   momentum_aekd_scale)
from .svm import find_optimal_svm, svm_weights
