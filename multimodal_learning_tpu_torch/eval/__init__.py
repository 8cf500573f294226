"""Evaluation: grading and survival metrics, prediction dumps, feature
diagnostics."""
from .analysis import load_pred_test, save_pred_test
from .diagnostics import evaluate_feature, intra_inter_similarity
from .metrics import (accuracy_cox, concordance_index, cox_log_rank,
                      extended_grading_metrics, grading_metrics, one_hot)
