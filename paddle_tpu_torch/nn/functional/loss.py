"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Each computes what the reference's does, in the same order of
operations, so the two agree to rounding: ``reduction`` is "mean", "sum"
or anything else for none (``kl_div`` also takes "batchmean"). The
model-parallel forms run in one process only: a ``group`` other than
None raises NotImplementedError (ROADMAP A.4).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "bce_loss", "cosine_embedding_loss", "cross_entropy", "ctc_loss",
           "dice_loss", "fused_linear_cross_entropy", "gaussian_nll_loss",
           "hinge_embedding_loss", "hsigmoid_loss", "huber_loss", "kl_div",
           "l1_loss", "log_loss", "margin_cross_entropy",
           "margin_ranking_loss", "mse_loss", "multi_label_soft_margin_loss",
           "multi_margin_loss", "nll_loss", "npair_loss", "poisson_nll_loss",
           "sigmoid_focal_loss", "smooth_l1_loss", "soft_margin_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss", "triplet_margin_with_distance_loss"]

_REDUCTIONS = ("mean", "sum", "none")


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross entropy over ``axis``, as the reference computes it.

    Hard labels (``label`` of input's shape without the class axis, or
    with a 1 there) pick each row's log-probability; a label equal to
    ``ignore_index`` contributes nothing and is left out of the mean,
    ``weight`` (``[classes]``) scales each row by its label's weight and
    the mean divides by the kept rows' weights, and ``label_smoothing``
    mixes in the row's mean negative log-probability. Soft labels
    (``soft_label``, or a label of input's shape) are distributions over
    the classes (smoothed toward uniform by ``label_smoothing``).
    ``use_softmax=False`` takes ``input`` as probabilities. ``reduction``
    is "mean", "sum" or "none". Under autocast narrow logits are raised
    to f32 first, as the reference's ``downcast_inputs`` does."""
    if reduction not in _REDUCTIONS:
        raise ValueError(f"reduction must be one of {_REDUCTIONS}, got "
                         f"{reduction!r}")
    (logits,) = downcast_inputs(input, opname="cross_entropy")
    axis = axis % logits.dim()
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    c = logits.shape[axis]
    if soft_label or (label.dim() == logits.dim()
                      and tuple(label.shape) == tuple(logits.shape)):
        tgt = label.to(logp.dtype)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / c
        return _reduce(-(tgt * logp).sum(dim=axis), reduction)
    if label.dim() == logits.dim():                 # a trailing 1
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    per = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        smooth = -logp.mean(dim=axis)
        per = (1 - label_smoothing) * per + label_smoothing * smooth
    if weight is not None:
        w = weight.to(per.dtype)[safe]
        per = per * w
    per = torch.where(valid, per, torch.zeros_like(per))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, w, torch.zeros_like(w)).sum()
        else:
            denom = valid.sum().to(per.dtype)
        return per.sum() / denom.clamp(min=1e-12)
    if reduction == "sum":
        return per.sum()
    return per


# ---- the fused head and loss: chunked, the logits never exist whole
def _chunk_logits(x, w):
    """``x @ w`` of one chunk, accumulated and returned in f32, as the
    reference's ``preferred_element_type=float32`` product: one GEMM with
    an f32 output when both are bf16 on CUDA, else the product of the
    operands raised to their promoted type (then f32)."""
    if x.dtype == w.dtype == torch.bfloat16 and x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.mm(x.to(dt), w.to(dt)).float()


class _FusedLinearCE(torch.autograd.Function):
    """``sum(valid * (logsumexp(x @ w) - (x @ w)[y])) / max(sum(valid),
    1)`` over chunks of ``chunk`` rows. The forward keeps only its
    inputs; the backward recomputes each chunk's logits and softmax,
    ``dlogits = (p - onehot(y)) * scale``, and accumulates ``dw`` in f32
    (the reference's ``_flce`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w, y, valid, chunk):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, x.shape[0], chunk):
            logits = _chunk_logits(x[i:i + chunk], w)
            lse = torch.logsumexp(logits, dim=-1)
            lab = logits.gather(1, y[i:i + chunk, None]).squeeze(1)
            total = total + ((lse - lab) * valid[i:i + chunk]).sum()
        ctx.save_for_backward(x, w, y, valid)
        ctx.chunk = chunk
        return total / valid.sum().clamp(min=1.0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        x, w, y, valid = ctx.saved_tensors
        chunk = ctx.chunk
        scales = ct / valid.sum().clamp(min=1.0) * valid
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(x)
        wf = w.float()
        for i in range(0, x.shape[0], chunk):
            xc = x[i:i + chunk]
            p = torch.softmax(_chunk_logits(xc, w), dim=-1)
            p[torch.arange(p.shape[0], device=p.device), y[i:i + chunk]] -= 1
            dlogits = p * scales[i:i + chunk, None]
            dx[i:i + chunk] = (dlogits @ wf.t()).to(x.dtype)
            dw += xc.float().t() @ dlogits
        return dx, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(hidden, weight, label, chunk_size=8192,
                               ignore_index=-100):
    """The mean softmax cross entropy of ``hidden @ weight`` (``hidden``
    ``[..., H]``, ``weight`` ``[H, vocab]``) against the integer ``label``
    (``hidden``'s leading shape) without the ``[tokens, vocab]`` logits:
    tokens go through in chunks of ``chunk_size`` rows, and the backward
    recomputes each chunk's softmax. Labels equal to ``ignore_index`` are
    left out of the mean (all of them ignored: 0)."""
    h = hidden.reshape(-1, hidden.shape[-1])
    y = label.reshape(-1)
    valid = (y != ignore_index).to(torch.float32)
    y = torch.where(y == ignore_index, torch.zeros_like(y), y).long()
    return _FusedLinearCE.apply(h, weight, y, valid,
                                max(1, min(int(chunk_size), h.shape[0])))


# ------------------------------------------------------ the other losses
def _where0(cond, v):
    return torch.where(cond, v, torch.zeros_like(v))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """:func:`cross_entropy` without reduction, the class axis kept as
    1; with ``return_softmax`` also the softmax of ``logits``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """Negative log-likelihood of log-probabilities ``[N, C]`` or ``[N,
    C, d...]`` at integer labels ``[N]`` / ``[N, d...]``; ignored labels
    give 0 and leave the mean, which divides by the kept labels'
    weights."""
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    logp = input.movedim(1, -1) if input.dim() > 2 else input
    per = -logp.gather(-1, safe[..., None]).squeeze(-1)
    if weight is not None:
        per = per * weight[safe]
    per = _where0(valid, per)
    if reduction == "mean":
        w = weight[safe] if weight is not None else torch.ones_like(per)
        return per.sum() / torch.clamp_min(_where0(valid, w).sum(), 1e-12)
    if reduction == "sum":
        return per.sum()
    return per


def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean"):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """The Huber form ``0.5 d^2 / delta`` below delta, ``d - 0.5 delta``
    above, times delta (the reference's scaling)."""
    d = (input - label).abs()
    per = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(per * delta, reduction)


def huber_loss(input, label, delta=1.0, reduction="mean"):
    d = (input - label).abs()
    per = torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(per, reduction)


def bce_loss(input, label, weight=None, reduction="mean"):
    """Binary cross entropy of probabilities clipped to [1e-12, 1 - 1e-7]."""
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    per = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


binary_cross_entropy = bce_loss


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    ls = torch.nn.functional.logsigmoid(logit)
    ls_neg = torch.nn.functional.logsigmoid(-logit)
    if pos_weight is not None:
        per = -(pos_weight * label * ls + (1 - label) * ls_neg)
    else:
        per = -(label * ls + (1 - label) * ls_neg)
    if weight is not None:
        per = per * weight
    return _reduce(per, reduction)


def kl_div(input, label, reduction="mean"):
    """``label (log label - input)`` with ``input`` log-probabilities;
    "batchmean" sums and divides by the batch."""
    per = label * (torch.log(torch.clamp_min(label, 1e-30)) - input)
    if reduction == "batchmean":
        return per.sum() / input.shape[0]
    return _reduce(per, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    per = torch.clamp_min(-label * (input - other) + margin, 0.0)
    return _reduce(per, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    per = torch.where(label == 1.0, input,
                      torch.clamp_min(margin - input, 0.0))
    return _reduce(per, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    per = torch.where(label == 1, 1.0 - cos,
                      torch.clamp_min(cos - margin, 0.0))
    return _reduce(per, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    def dist(u, v):
        return ((u - v + epsilon).abs() ** p).sum(dim=-1) ** (1.0 / p)
    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    """:func:`triplet_margin_loss` with ``distance_function(a, b)`` (the
    pairwise 2-norm when None)."""
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def soft_margin_loss(input, label, reduction="mean"):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    logsig = torch.nn.functional.logsigmoid
    per = -(label * logsig(input) + (1 - label) * logsig(-input))
    if weight is not None:
        per = per * weight
    return _reduce(per.mean(dim=-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean"):
    if log_input:
        per = torch.exp(input) - label * input
    else:
        per = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label) - label \
            + 0.5 * torch.log(2 * math.pi * label)
        per = per + _where0(label > 1, stirling)
    return _reduce(per, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = torch.clamp_min(variance, epsilon)
    per = 0.5 * (torch.log(var) + torch.square(label - input) / var)
    if full:
        per = per + 0.5 * math.log(2 * math.pi)
    return _reduce(per, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the log-alpha recursion over time, as the reference's
    ``lax.scan``: ``log_probs`` ``[T, N, C]`` logits (log-softmaxed
    here), ``labels`` ``[N, S]``; steps past a row's input length keep
    its alphas. The loss is ``-logaddexp`` of the alphas at ``2 L`` and
    ``2 L - 1`` for label length L; "mean" divides each by ``max(L, 1)``
    first. ``norm_by_times`` is read by neither package. A plain loop
    over T of device ops: no host read."""
    lp = torch.log_softmax(log_probs, dim=-1)
    t_len, n, _ = lp.shape
    ext = 2 * labels.shape[1] + 1
    lab = labels.long()
    ext_labels = torch.full((n, ext), blank, dtype=torch.long,
                            device=lp.device)
    ext_labels[:, 1::2] = lab
    neg = torch.full((), -1e30, dtype=lp.dtype, device=lp.device)
    pad1 = neg.expand(n, 1)
    pad2 = neg.expand(n, 2)
    alpha = torch.cat([lp[0, :, blank:blank + 1],
                       lp[0].gather(1, ext_labels[:, 1:2]),
                       neg.expand(n, ext - 2)], dim=1)
    same = torch.cat([torch.ones(n, 2, dtype=torch.bool, device=lp.device),
                      ext_labels[:, 2:] == ext_labels[:, :-2]], dim=1)
    allow_skip = (ext_labels != blank) & ~same
    in_len = input_lengths.to(lp.device)
    for t in range(1, t_len):
        emit = lp[t].gather(1, ext_labels)
        cand = torch.logaddexp(alpha, torch.cat([pad1, alpha[:, :-1]], 1))
        cand = torch.where(allow_skip, torch.logaddexp(
            cand, torch.cat([pad2, alpha[:, :-2]], 1)), cand)
        alpha = torch.where((t < in_len)[:, None], cand + emit, alpha)
    end = (2 * label_lengths.to(lp.device)).long()
    last = alpha.gather(1, end[:, None])[:, 0]
    prev = alpha.gather(1, torch.clamp_min(end - 1, 0)[:, None])[:, 0]
    loss = -torch.logaddexp(last, prev)
    if reduction == "mean":
        return (loss / torch.clamp_min(
            label_lengths.to(loss.device, loss.dtype), 1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    p = torch.sigmoid(logit)
    logsig = torch.nn.functional.logsigmoid
    ce = -(label * logsig(logit) + (1 - label) * logsig(-logit))
    pt = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    per = a_t * ((1 - pt) ** gamma) * ce
    if normalizer is not None:
        per = per / normalizer
    return _reduce(per, reduction)


def dice_loss(input, label, epsilon=1e-5):
    """``mean(1 - (2 |p y| + eps) / (|p| + |y| + eps))`` over the batch,
    y the one-hot of ``label[..., 0]`` over input's last axis."""
    y1 = torch.nn.functional.one_hot(label[..., 0].long(),
                                     input.shape[-1]).to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * y1).sum(dim=red)
    union = input.sum(dim=red) + y1.sum(dim=red)
    return (1.0 - (2 * inter + epsilon) / (union + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def square_error_cost(input, label):
    return torch.square(input - label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """N-pair loss: cross entropy of ``anchor @ positive^T`` against the
    row-normalised label-equality targets, plus ``l2_reg / 4`` times the
    mean squared norms."""
    sim = anchor @ positive.t()
    tgt = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    ce = -(tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return ce + reg


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    """``sum_{j != y} max(0, margin - x_y + x_j)^p / C`` per row, the
    terms scaled by ``weight[y]`` (a ``[C]`` weight) or by ``weight``
    itself (any other shape)."""
    n, c = input.shape
    y = label.reshape(-1).long()
    m = torch.clamp_min(margin - input.gather(1, y[:, None]) + input, 0.0)
    if p != 1:
        m = m ** p
    if weight is not None:
        m = m * (weight[y].reshape(n, 1) if weight.dim() == 1 else weight)
    mask = 1.0 - torch.nn.functional.one_hot(y, c).to(input.dtype)
    return _reduce((m * mask).sum(dim=1) / c, reduction)


_hsigmoid_paths = {}


def _default_hsigmoid_paths(n_cls, device):
    """The reference's default tree: for each class, the non-leaf ids
    (0-based) from the root to leaf ``class + n_cls`` of the implicit
    heap, and the turns taken, each padded with -1 to the depth + 1;
    ``[n_cls, L]`` int64 tables made once a class count and device."""
    key = (n_cls, str(device))
    if key not in _hsigmoid_paths:
        depth = int(np.ceil(np.log2(max(n_cls, 2))))
        tables, codes = [], []
        for lab in range(n_cls):
            node, tab, code = lab + n_cls, [], []
            while node > 1:
                code.append(node & 1)
                node //= 2
                tab.append(node - 1)
            pad = depth + 1 - len(tab)
            tables.append(tab[::-1] + [-1] * pad)
            codes.append(code[::-1] + [-1] * pad)
        _hsigmoid_paths[key] = (
            torch.tensor(np.asarray(tables, np.int64), device=device),
            torch.tensor(np.asarray(codes, np.int64), device=device))
    return _hsigmoid_paths[key]


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid: the sum of the sigmoid cross entropies of
    the scores ``input @ weight[node]`` (+ ``bias[node]``) along each
    label's path against its turns, ``[N, 1]``. Without ``path_table``
    / ``path_code`` (``[N, L]``, -1 padded) the paths are the default
    tree's (:func:`_default_hsigmoid_paths`)."""
    if path_table is None or path_code is None:
        t_all, c_all = _default_hsigmoid_paths(num_classes, input.device)
        y = label.reshape(-1).long()
        path_table, path_code = t_all[y], c_all[y]
    valid = path_table >= 0
    tab = torch.clamp_min(path_table, 0).long()
    s = torch.einsum("nd,nld->nl", input, weight[tab])
    if bias is not None:
        s = s + bias[tab]
    target = path_code.to(torch.float32)
    bce = torch.clamp_min(s, 0) - s * target + torch.log1p(
        torch.exp(-s.abs()))
    return (bce * valid).sum(dim=1, keepdim=True)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace's margin softmax: the label's cosine (clipped inside
    (-1, 1)) becomes ``cos(margin1 theta + margin2) - margin3``, every
    logit is scaled by ``scale``, then softmax cross entropy ``[N, 1]``
    (and the softmax with ``return_softmax``). One process only: the
    class-sharded form over ``group`` comes with ROADMAP A.4."""
    if group is not None:
        raise NotImplementedError(
            "margin_cross_entropy: a model-parallel group comes with the "
            "mesh (ROADMAP A.4); pass group=None")
    n, c = logits.shape
    y = label.reshape(-1).long()
    cos = torch.clamp(logits, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = torch.arccos(cos.gather(1, y[:, None]))
    target = torch.cos(margin1 * theta + margin2) - margin3
    onehot = torch.nn.functional.one_hot(y, c).to(logits.dtype)
    z = (cos * (1 - onehot) + target * onehot) * scale
    loss = _reduce(-torch.log_softmax(z, dim=-1).gather(1, y[:, None]),
                   reduction)
    return (loss, torch.softmax(z, dim=-1)) if return_softmax else loss
