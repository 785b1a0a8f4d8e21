"""Evaluation metrics (counterpart of auformer/metrics), numpy only."""
from .metrics import (AccF1Metric, CCCMetric, MultiLabelAccF1, acc_f1_score,
                      accuracy_score, ccc, cccva, composite_scores, f1_score)

__all__ = ["AccF1Metric", "CCCMetric", "MultiLabelAccF1", "acc_f1_score",
           "accuracy_score", "ccc", "cccva", "composite_scores", "f1_score"]
