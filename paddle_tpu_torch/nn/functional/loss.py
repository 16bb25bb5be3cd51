"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]

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
