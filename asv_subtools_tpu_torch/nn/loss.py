"""Classification losses for speaker recognition (counterpart: asv_subtools_tpu/nn/loss.py).

Each loss is a module built as ``cls(input_dim, num_targets, **params)``
that owns its classifier weight; ``forward(embeddings, targets)`` returns
``(loss, logits)``. The margin heads (:class:`MarginSoftmaxLoss`,
:class:`MarginSoftmaxLossV1`) also take ``lambda_m`` and
``margin_offset``; their logits are the scaled cosines before the margin
(what accuracy is read from), and train mode (``module.training``)
applies the margin while eval mode returns the cross entropy of the plain
logits. :class:`SoftmaxLoss` and :class:`FocalLoss` are an affine layer
and a cross entropy (the same in both modes);
:class:`LogisticAffinityLoss` scores every pair of the batch
(logits ``[B, B]``) and :class:`OCSoftmax` every row against one centre
(logits ``[B, 1]``): neither has classes, and accuracy over their logits
is what the JAX step reports for them.

The cosine product and all margin trigonometry run in float32 whatever
the compute type (the reference forces f32 under AMP there); as in the JAX
module, :class:`MarginSoftmaxLoss` keeps float64 in float64 and
:class:`MarginSoftmaxLossV1` computes in float32 always. Thresholds and
hard-example masks carry no gradient. ``lambda_m`` and ``margin_offset`` may be floats or tensors on
the device, so a margin schedule costs no host sync.

Under a mesh step whose ``"model"`` group shards the classifier's rows
(parallel/mesh.py ``classifier_partition_rules``; the weight a margin
head is handed then has fewer rows than ``num_targets * sub_k``), each
model rank computes the cosines of its rows and gathers them with
autograd (parallel/comm.py) before the margin, the sub-centre max, the
top-k and the softmax, which are unchanged: values equal the unsharded
head's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import comm

_EPS = 1.0e-10
Scalar = Union[float, torch.Tensor]


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, label_smoothing: float = 0.0,
                  reduction: str = "mean") -> torch.Tensor:
    """Cross entropy over int targets, with label smoothing (mean of -log p
    over the classes, weighted by the smoothing)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (-logp.mean(-1))
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == targets).to(torch.float32).mean()


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)


def _cosines(x: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """normalize(x) @ normalize(w).T; with ``w`` a model rank's block of
    the ``rows`` classifier rows, the blocks of every model rank gathered
    along the last dim."""
    xn, wn = _normalize(x), _normalize(w)
    if w.shape[0] == rows:
        return xn @ wn.t()
    axis = comm.model_group()
    if axis is None or w.shape[0] * axis.size != rows:
        raise ValueError(f"classifier of {w.shape[0]} rows for {rows} outside a mesh step that shards it")
    return comm.gather_from_model(comm.copy_to_model(xn, axis) @ wn.t(), axis)


def _whole_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    """Every row of the classifier, gathered from the model ranks when
    ``w`` is one rank's block (the gradient keeps this rank's rows)."""
    if w.shape[0] == rows:
        return w
    axis = comm.model_group()
    return comm.gather_from_model(w.t(), axis).t()


def _margin(m: float, offset: Scalar) -> Scalar:
    """max(m + offset, 0): a float for a float offset, a tensor for a
    tensor. Numbers stay Python numbers: a tensor made from one on the card
    would be a blocking host-to-device copy."""
    if isinstance(offset, torch.Tensor):
        return torch.clamp_min(offset + m, 0.0)
    return max(m + offset, 0.0)


class SoftmaxLoss(nn.Module):
    """``affine`` (a Linear with bias) and the cross entropy of its logits
    over the temperature ``t``, with label smoothing."""

    def __init__(self, input_dim: int, num_targets: int, t: float = 1.0, label_smoothing: float = 0.0):
        super().__init__()
        self.t, self.label_smoothing = t, label_smoothing
        self.affine = nn.Linear(input_dim, num_targets)

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.affine(embeddings)
        return cross_entropy(logits / self.t, targets, self.label_smoothing), logits


class FocalLoss(nn.Module):
    """Focal loss over ``affine``'s logits: -(1 - p_y)^gamma log p_y, with
    p clamped at 1e-10 before the log. The reduction defaults to the sum,
    as the reference's NLLLoss there."""

    def __init__(self, input_dim: int, num_targets: int, gamma: float = 2.0, reduction: str = "sum"):
        super().__init__()
        self.gamma, self.reduction = gamma, reduction
        self.affine = nn.Linear(input_dim, num_targets)

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.affine(embeddings)
        p = torch.softmax(logits, dim=-1)
        focal = (1.0 - p) ** self.gamma * torch.log(torch.clamp_min(p, _EPS))
        nll = -focal.gather(-1, targets[..., None].long())[..., 0]
        return (comm.batch_sum(nll.sum()) if self.reduction == "sum" else nll.mean()), logits


class LogisticAffinityLoss(nn.Module):
    """Pairwise logistic loss: scores = w * cos(e_i, e_j) + b over every
    pair of the batch (the cosines in float32, the scores in the wider of
    that and w's type), -mean(log sigmoid(+-scores)) with + for pairs of
    one class. Scalars ``w`` and ``b``; no classifier, so ``input_dim``
    and ``num_targets`` are unused."""

    def __init__(self, input_dim: int = 0, num_targets: int = 0, init_w: float = 5.0, init_b: float = -1.0):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(float(init_w)))
        self.b = nn.Parameter(torch.tensor(float(init_b)))

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e = _normalize(embeddings.float())
        # in a mesh step: this rank's rows against the global batch's
        cos = e @ comm.all_gather_with_grad(e).t()
        scores = self.w * cos.to(torch.promote_types(self.w.dtype, cos.dtype)) + self.b
        every = comm.all_gather_with_grad(targets)
        sign = 2.0 * (targets[:, None] == every[None, :]).to(scores.dtype) - 1.0
        return -F.logsigmoid(sign * scores).mean(), scores


class OCSoftmax(nn.Module):
    """One-class softmax for anti-spoofing: the cosine of each embedding to
    ``center`` ``[1, D]`` in float32; bona fide has label 1, spoof 0.
    ``convention="reference"`` is the reference's code (bona fide pushed
    below ``r_real``, spoof above ``r_fake``), ``"paper"`` the published
    eq. 8 (bona fide above ``r_real``, spoof below ``r_fake``); the loss is
    mean(softplus(alpha * margin)). Logits: the cosines ``[B, 1]``."""

    def __init__(self, input_dim: int, num_targets: int = 0, r_real: float = 0.9, r_fake: float = 0.2,
                 alpha: float = 20.0, convention: str = "reference"):
        super().__init__()
        if convention not in ("reference", "paper"):
            raise ValueError(f"convention must be 'reference' or 'paper', got {convention!r}")
        self.r_real, self.r_fake, self.alpha, self.convention = r_real, r_fake, alpha, convention
        limit = math.sqrt(0.75)  # flax variance_scaling(0.25, "fan_in", "uniform") of a [1, D] kernel
        self.center = nn.Parameter(torch.empty(1, input_dim).uniform_(-limit, limit))

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        scores = (_normalize(embeddings.float()) @ _normalize(self.center.float()).t())[:, 0]
        is_real = targets == 1
        if self.convention == "paper":
            margin = torch.where(is_real, self.r_real - scores, scores - self.r_fake)
        else:
            margin = torch.where(is_real, scores - self.r_real, self.r_fake - scores)
        # softplus(z) = -log sigmoid(-z), exact where torch's softplus turns linear
        return -F.logsigmoid(-self.alpha * margin).mean(), scores[:, None]


class MarginSoftmaxLoss(nn.Module):
    """AM / AAM / SM1-3 margin softmax with the reference's extras: double
    margin, ring loss, minimum hyperspherical energy, inter loss and the
    CurricularFace component. ``weight`` is ``[num_targets, D]``."""

    def __init__(self, input_dim: int, num_targets: int, m: float = 0.2, s: float = 30.0, t: float = 1.0,
                 method: str = "am", double: bool = False, feature_normalize: bool = True,
                 mhe_loss: bool = False, mhe_w: float = 0.01, inter_loss: float = 0.0,
                 ring_loss: float = 0.0, curricular: bool = False, label_smoothing: float = 0.0,
                 eps: float = _EPS):
        super().__init__()
        if method not in ("am", "aam", "sm1", "sm2", "sm3"):
            raise ValueError(f"Unknown margin method {method!r}")
        self.num_targets, self.m, self.s, self.t, self.method = num_targets, m, s, t, method
        self.double_margin, self.feature_normalize = double, feature_normalize
        self.mhe_loss, self.mhe_w, self.inter_loss = mhe_loss, mhe_w, inter_loss
        self.ring_loss, self.curricular = ring_loss, curricular
        self.label_smoothing, self.eps = label_smoothing, eps
        self.weight = nn.Parameter(torch.randn(num_targets, input_dim) * 0.01)
        if ring_loss > 0:
            self.ring_r = nn.Parameter(torch.tensor(20.0))
        if curricular:
            self.register_buffer("curricular_t", torch.zeros(()))

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor, lambda_m: Scalar = 1.0,
                margin_offset: Scalar = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        x32, w32 = _at_least_f32(embeddings), _at_least_f32(self.weight)
        cos = _cosines(x32, w32, self.num_targets)
        if self.feature_normalize:
            scale = self.s
        else:
            scale = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
        logits = scale * cos
        if not self.training:
            return cross_entropy(logits, targets, self.label_smoothing), logits

        m = _margin(self.m, margin_offset)
        onehot = F.one_hot(targets.long(), self.num_targets).to(cos.dtype)
        cos_t = (cos * onehot).sum(-1, keepdim=True)
        cos_others = cos
        if self.method == "am":
            pen_t = cos_t - m
            if self.double_margin:
                cos_others = cos + m
        elif self.method == "aam":
            pen_t = torch.cos(torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) + m)
            if self.double_margin:
                cos_others = torch.cos(torch.arccos(torch.clamp(cos, -1.0, 1.0)) - m)
        elif self.method == "sm1":
            pen_t = (1.0 + m) * cos_t - m
        elif self.method == "sm2":
            pen_t = cos_t - (1.0 - cos_t ** 2) * m
        else:
            pen_t = cos_t - (1.0 - cos_t) ** 2 * m

        lam = lambda_m
        pen_t = lam * pen_t + (1.0 - lam) * cos_t
        if self.double_margin:
            cos_others = lam * cos_others + (1.0 - lam) * cos
        if self.curricular:
            # the buffer moves before the hard-example rescale reads it
            # (momentum 0.01), as the reference's CurricularMarginComponent
            tv = 0.99 * comm.batch_mean(cos_t.detach().mean()) + 0.01 * self.curricular_t
            hard = cos_others > pen_t
            cos_others = torch.where(hard, cos_others * (tv + cos_others), cos_others)
            self.curricular_t = tv.to(self.curricular_t.dtype)

        out = scale * torch.where(onehot > 0, pen_t, cos_others)
        loss = cross_entropy(out / self.t, targets, self.label_smoothing)
        if self.ring_loss > 0:
            loss = loss + self.ring_loss * ((scale - self.ring_r) ** 2).mean() / 2.0
        if self.mhe_loss:
            wn = _normalize(_whole_rows(w32, self.num_targets))
            d2 = ((wn[None, :, :] - wn[targets.long()][:, None, :]) ** 2).sum(-1)
            d2 = torch.where(onehot > 0, torch.full_like(d2, math.inf), torch.clamp_min(d2, self.eps))
            energy = torch.where(onehot > 0, torch.zeros_like(d2), 1.0 / d2)
            loss = loss + self.mhe_w * energy.sum() / (targets.shape[0] * (self.num_targets - 1))
        if self.inter_loss > 0:
            p = torch.softmax(scale * cos, dim=-1)
            p_t = (p * onehot).sum(-1)
            inter = torch.log((p.sum(-1) - p_t) / (self.num_targets - 1) + self.eps)
            loss = loss + self.inter_loss * inter.mean()
        return loss, logits


class MarginSoftmaxLossV1(nn.Module):
    """Sub-center margin softmax with an adaptive inter-class margin.

    ``sub_k`` sub-centres per class (the cosine is their max);
    ``adapt_method`` "topk" adds ``ada_m / m`` of the margin to each row's
    ``topk`` hardest non-target classes, "batch_mean" to those above the
    batch's mean target cosine less ``lambda_bm`` (and takes half of it off
    every class), None adds none; ``loss_type`` "softmax" or "rectangle".
    ``weight`` is ``[num_targets * sub_k, D]``, class-major.
    """

    def __init__(self, input_dim: int, num_targets: int, sub_k: int = 1, method: str = "am", m: float = 0.2,
                 adapt_method: Optional[str] = None, ada_m: float = 0.1, s: float = 30.0, topk: int = 5,
                 lambda_bm: float = 0.1, loss_type: str = "softmax", label_smoothing: float = 0.0,
                 eps: float = _EPS):
        super().__init__()
        if method not in ("am", "aam"):
            raise ValueError(f"Unknown margin method {method!r}")
        if adapt_method not in ("topk", "batch_mean", None):
            raise ValueError(f"Unknown adapt_method {adapt_method!r}")
        if loss_type not in ("softmax", "rectangle"):
            raise ValueError(f"Unsupported loss type {loss_type!r}")
        self.num_targets, self.sub_k = num_targets, max(1, sub_k)
        self.method, self.m, self.adapt_method, self.ada_m, self.s = method, m, adapt_method, ada_m, s
        self.topk, self.lambda_bm, self.loss_type = topk, lambda_bm, loss_type
        self.label_smoothing, self.eps = label_smoothing, eps
        self.weight = nn.Parameter(torch.randn(num_targets * self.sub_k, input_dim) * 0.01)

    def forward(self, embeddings: torch.Tensor, targets: torch.Tensor, lambda_m: Scalar = 1.0,
                margin_offset: Scalar = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
        c, k = self.num_targets, self.sub_k
        cos = _cosines(embeddings.float(), self.weight.float(), c * k)
        if k > 1:
            cos = cos.view(-1, c, k).amax(-1)
        logits = self.s * cos
        if not self.training:
            return cross_entropy(logits, targets, self.label_smoothing), logits

        add_m = _margin(self.m, margin_offset)
        ada_scale = self.ada_m / self.m
        onehot = F.one_hot(targets.long(), c).to(cos.dtype)
        cos_t = (cos * onehot).sum(-1, keepdim=True)
        cos_n = cos.masked_fill(onehot > 0, -math.inf)
        if self.adapt_method == "topk":
            with torch.no_grad():
                th = torch.topk(cos_n, self.topk, dim=-1).values[:, -1:]
                hard = (cos_n >= th).to(cos.dtype)
            hard_margin = ada_scale * add_m * hard
        elif self.adapt_method == "batch_mean":
            with torch.no_grad():
                th = comm.batch_mean(cos_t.mean()) - self.lambda_bm
                hard = (cos_n >= th).to(cos.dtype)
            hard_margin = ada_scale * add_m * hard - ada_scale * add_m / 2.0
        else:
            hard_margin = torch.zeros_like(cos)

        if self.method == "am":
            pen = torch.where(onehot > 0, cos_t, cos_n + hard_margin + add_m)
        else:
            pen_t = torch.cos(torch.arccos(torch.clamp(cos_t, -1.0, 1.0)) + add_m)
            if self.adapt_method:
                pen_n = torch.cos(torch.arccos(torch.clamp(cos, -1.0, 1.0)) - hard_margin)
            else:
                pen_n = cos
            pen = torch.where(onehot > 0, pen_t, pen_n)

        lam = lambda_m
        if self.loss_type == "softmax":
            pen = lam * pen + (1.0 - lam) * cos
            return cross_entropy(self.s * pen, targets, self.label_smoothing), logits
        bs = targets.shape[0]
        pen_n_only = pen.masked_fill(onehot > 0, -math.inf)
        avg_nlog = comm.batch_logsumexp(torch.logsumexp((self.s * pen_n_only).flatten(), 0)) - math.log(
            comm.batch_rows(bs))
        rect = F.softplus(-self.s * torch.where(onehot > 0, pen, torch.zeros_like(pen)).sum(-1) + avg_nlog)
        ce = cross_entropy(self.s * cos, targets, self.label_smoothing)
        return (1.0 - lam) * ce + lam * rect.sum() / bs, logits


class MarginWarm:
    """Margin warm-up schedule (reference loss.py:399-465), host-side.

    Between start_epoch and end_epoch the margin offset decays
    exponentially from ``offset_margin`` (usually negative) to 0 while
    lambda rises linearly from ``init_lambda`` to 1. ``step(cur_step)``
    returns (offset_margin, lambda_m) to feed the loss.
    """

    def __init__(self, start_epoch: int, end_epoch: int, offset_margin: float = 0.0, init_lambda: float = 1.0,
                 epoch_iter: Optional[int] = None):
        if end_epoch < start_epoch:
            raise ValueError("end_epoch must be >= start_epoch")
        if not 0.0 <= init_lambda <= 1.0:
            raise ValueError("init_lambda must be in [0, 1]")
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.offset_margin = offset_margin
        self.init_lambda = init_lambda
        self.epoch_iter = epoch_iter
        if epoch_iter:
            self.update_step_range(epoch_iter, overwrite=True)

    def update_step_range(self, epoch_iter: int, overwrite: bool = False) -> None:
        if not overwrite and self.epoch_iter:
            raise ValueError("epoch_iter already set")
        self.epoch_iter = epoch_iter
        self.increase_start_iter = (self.start_epoch - 1) * epoch_iter
        self.fix_start_iter = (self.end_epoch - 1) * epoch_iter
        self.step_range = max(1, self.fix_start_iter - self.increase_start_iter)

    def step(self, cur_step: int) -> Tuple[float, float]:
        if not self.epoch_iter or self.epoch_iter < 0:
            raise ValueError("epoch_iter must be set before stepping")
        if cur_step >= self.fix_start_iter:
            return 0.0, 1.0
        if cur_step <= self.increase_start_iter:
            return self.offset_margin, self.init_lambda
        pos = cur_step - self.increase_start_iter
        ratio = math.exp((pos / self.step_range) * math.log(1e-3))
        lam = self.init_lambda + (pos / self.step_range) * (1.0 - self.init_lambda)
        return self.offset_margin * ratio, lam


class LambdaMAnneal:
    """A-softmax-style lambda annealing (reference snowdar_xvector.py:355-387):
    ``lambda_m = 1 / (1 + max(lambda_0, lambda_b * (1 + gamma*step)**-alpha))``.
    Same interface as :class:`MarginWarm`."""

    def __init__(self, lambda_0: float = 0.0, lambda_b: float = 1000.0, alpha: float = 5.0, gamma: float = 1e-4):
        self.lambda_0 = lambda_0
        self.lambda_b = lambda_b
        self.alpha = alpha
        self.gamma = gamma

    def step(self, cur_step: int) -> Tuple[float, float]:
        factor = max(self.lambda_0, self.lambda_b * (1.0 + self.gamma * cur_step) ** (-self.alpha))
        return 0.0, 1.0 / (1.0 + factor)


def mixup_loss(loss_fn: Callable, logits_or_emb: torch.Tensor, targets: torch.Tensor, lam: Scalar,
               index: torch.Tensor) -> torch.Tensor:
    """``lam * loss_fn(x, targets) + (1 - lam) * loss_fn(x, targets[index])``
    (JAX nn/loss.py:384-388)."""
    return lam * loss_fn(logits_or_emb, targets) + (1.0 - lam) * loss_fn(logits_or_emb, targets[index])


LOSSES = {
    "softmax": SoftmaxLoss,
    "focal": FocalLoss,
    "margin_softmax": MarginSoftmaxLoss,
    "margin_softmax_v1": MarginSoftmaxLossV1,
    "logistic_affinity": LogisticAffinityLoss,
    "ocsoftmax": OCSoftmax,
}
# the heads that take lambda_m and margin_offset (JAX framework.py:65-66)
MARGIN_LOSSES = ("margin_softmax", "margin_softmax_v1")
