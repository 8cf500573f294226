"""Evaluation: grading and survival metrics, prediction dumps and their
patient-level analysis, the Cox baseline fitter, feature diagnostics."""
from .analysis import load_pred_test, save_pred_test
from .coxph import fit_coxph, predict_partial_hazard, train_cox_cv
from .diagnostics import evaluate_feature, intra_inter_similarity
from .metrics import (accuracy_cox, concordance_index, cox_log_rank,
                      extended_grading_metrics, grading_metrics, one_hot)
