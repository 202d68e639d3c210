"""Statistical back-end: transforms, PLDA, score normalization, metrics.

Counterpart: asv_subtools_tpu/backend, with the same exports. The
replacement for the reference's score/ + Kaldi ivector-* binaries: numpy
array programs on the host (f64), with the cosine score matrices, AS-norm
(``asnorm_device``) and the PLDA LLR matrix (``plda.llr_matrix_device``)
in f32 torch on the device. sklearn and matplotlib are imported only by
the functions that need them.
"""

from .classifiers import (
    DiagGmm,
    LinearClassifier,
    gmm_lid_scores,
    train_diag_gmm,
    train_logistic_regression,
    train_svm,
)
from .figure import det_curve_points, plot_det, plot_score_distribution
from .fusion import greedy_fusion, lda_fusion, logistic_fusion, svm_fusion, weight_fusion
from .adaptation import (
    TwoCovPlda,
    adapt_plda_cip,
    adapt_plda_cip_reg,
    adapt_plda_coral,
    adapt_plda_coral_plus,
    adapt_plda_lip,
    adapt_plda_lip_reg,
    adapt_plda_unsupervised,
)
from .metrics import (
    compute_cavg,
    compute_eer,
    compute_eer_bosaris,
    compute_eer_kaldi,
    compute_min_dcf,
    compute_min_tdcf,
    retrieval_map,
    roc_curve,
)
from .pipeline import ScoreConfig, ScoreSets
from .ivector import (
    KaldiIvectorExtractor,
    read_kaldi_ivector_extractor,
    write_kaldi_ivector_extractor,
    BaumWelchStats,
    IvectorExtractor,
    collect_stats,
    train_ivector_extractor,
    train_ubm,
)
from .plda import (
    Plda,
    PldaStats,
    estimate_plda,
    plda_score_trials,
    plda_from_two_cov,
    read_kaldi_plda,
    read_kaldi_plda_text,
    read_two_cov_ark,
    write_kaldi_plda,
    write_kaldi_plda_text,
    write_two_cov_ark,
)
from .score_norm import asnorm, asnorm_device, cosine_score_matrix, snorm
from .transforms import (
    TransformChain,
    PCAWhitening,
    ZCAWhitening,
    apply_lda,
    global_mean,
    length_norm,
    speaker_means,
    train_lda,
)
from .trials import Trials, read_scores, write_scores
