"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): each
holds its options and calls its functional
(:mod:`paddle_tpu_torch.nn.functional.loss`)."""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import loss as F_loss
from paddle_tpu_torch.nn.layer.common import normal_parameter, param_attrs

__all__ = ["BCELoss", "BCEWithLogitsLoss", "CTCLoss", "CosineEmbeddingLoss",
           "CrossEntropyLoss", "GaussianNLLLoss", "HSigmoidLoss",
           "HingeEmbeddingLoss", "HuberLoss", "KLDivLoss", "L1Loss",
           "MSELoss", "MarginRankingLoss", "MultiLabelSoftMarginLoss",
           "MultiMarginLoss", "NLLLoss", "PoissonNLLLoss", "SmoothL1Loss",
           "SoftMarginLoss", "TripletMarginLoss",
           "TripletMarginWithDistanceLoss"]


class _Loss(nn.Module):
    """Stores its keyword options as attributes, in the reference's
    names; ``forward`` passes them on by name."""

    _fn = None

    def __init__(self, **options):
        super().__init__()
        options.pop("name", None)
        self._options = list(options)
        for k, v in options.items():
            setattr(self, k, v)

    def forward(self, *inputs):
        return getattr(F_loss, self._fn)(
            *inputs, **{k: getattr(self, k) for k in self._options})


class CrossEntropyLoss(_Loss):
    _fn = "cross_entropy"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax,
                         label_smoothing=label_smoothing)


class MSELoss(_Loss):
    _fn = "mse_loss"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _fn = "l1_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class NLLLoss(_Loss):
    _fn = "nll_loss"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class HuberLoss(_Loss):
    _fn = "huber_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CTCLoss(nn.Module):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F_loss.ctc_loss(log_probs, labels, input_lengths,
                               label_lengths, self.blank, self.reduction,
                               norm_by_times)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _fn = "cosine_embedding_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class TripletMarginWithDistanceLoss(_Loss):
    _fn = "triplet_margin_with_distance_loss"

    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__(distance_function=distance_function, margin=margin,
                         swap=swap, reduction=reduction)


class SoftMarginLoss(_Loss):
    _fn = "soft_margin_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class MultiLabelSoftMarginLoss(_Loss):
    _fn = "multi_label_soft_margin_loss"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class PoissonNLLLoss(_Loss):
    _fn = "poisson_nll_loss"

    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__(log_input=log_input, full=full, epsilon=epsilon,
                         reduction=reduction)


class GaussianNLLLoss(_Loss):
    _fn = "gaussian_nll_loss"

    def __init__(self, full=False, epsilon=1e-6, reduction="mean",
                 name=None):
        super().__init__(full=full, epsilon=epsilon, reduction=reduction)


class MultiMarginLoss(_Loss):
    _fn = "multi_margin_loss"

    def __init__(self, p=1, margin=1.0, weight=None, reduction="mean",
                 name=None):
        super().__init__(p=p, margin=margin, weight=weight,
                         reduction=reduction)


class HSigmoidLoss(nn.Module):
    """Hierarchical sigmoid over its non-leaf classifier table:
    ``weight [num_classes - 1, feature_size]`` (``[num_classes, ...]``
    with ``is_custom``) drawn from Normal(0, 1/sqrt(feature_size)), and
    ``bias`` of as many rows (zeros; none with ``bias_attr=False``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        bias = param_attrs("HSigmoidLoss", weight_attr=weight_attr,
                           bias_attr=bias_attr)
        self.num_classes = num_classes
        rows = num_classes if is_custom else num_classes - 1
        self.weight = normal_parameter((rows, feature_size),
                                       feature_size ** -0.5, device, dtype,
                                       generator)
        self.bias = nn.Parameter(torch.zeros(
            rows, device=device, dtype=dtype)) if bias else None

    def forward(self, input, label, path_table=None, path_code=None):
        return F_loss.hsigmoid_loss(input, label, self.num_classes,
                                    self.weight, bias=self.bias,
                                    path_table=path_table,
                                    path_code=path_code)
