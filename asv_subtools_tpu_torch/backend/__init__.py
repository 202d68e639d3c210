from .metrics import compute_eer, roc_curve
from .score_norm import cosine_score_matrix

__all__ = ["compute_eer", "cosine_score_matrix", "roc_curve"]
