"""Evaluation: grading and survival metrics, prediction dumps."""
from .analysis import load_pred_test, save_pred_test
from .metrics import (accuracy_cox, concordance_index, cox_log_rank,
                      extended_grading_metrics, grading_metrics, one_hot)
