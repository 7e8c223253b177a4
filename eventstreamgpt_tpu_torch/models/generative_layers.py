"""Distribution-producing emission heads (TTE + regression).

Counterpart: ``eventstreamgpt_tpu/models/generative_layers.py``. The
strided slices of the projection output are kept exactly: ``0::3`` /
``1::3`` / ``2::3`` for the lognormal mixture, ``0::2`` / ``1::2`` for
Gaussian heads; the positive transform is ``ELU + 1 + finfo.tiny``. The
indexed regression head's training path gathers the observed targets'
parameters with `ops.vocab_gather` (kernel C on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributions import Exponential, LogNormalMixture, Normal
from ..ops.tensor_ops import dense, exact_dense
from ..ops.vocab_gather import vocab_gather


def elu_plus_one(x: torch.Tensor) -> torch.Tensor:
    """ELU(x) + 1 + tiny: strictly positive."""
    return F.elu(x) + 1.0 + torch.finfo(x.dtype).tiny


class LogNormalMixtureTTELayer(nn.Module):
    """Lognormal-mixture time-to-event head.

    The flax layer has no ``dtype``, so its product runs in fp32 even under
    bf16 precision; ``proj`` is marked to stay fp32 when the model casts.
    ``exact`` (generation) takes the product through
    `ops.tensor_ops.exact_dense`.
    """

    def __init__(self, in_dim, num_components, mean_log_inter_time=0.0, std_log_inter_time=1.0):
        super().__init__()
        self.proj = nn.Linear(in_dim, 3 * num_components)
        self.proj.keep_fp32 = True
        self.mean_log_inter_time = mean_log_inter_time
        self.std_log_inter_time = std_log_inter_time

    def forward(self, T, exact: bool = False):
        p = (exact_dense if exact else dense)(T, self.proj, torch.float32)
        return LogNormalMixture(
            locs=p[..., 0::3],
            log_scales=p[..., 1::3],
            log_weights=p[..., 2::3],
            mean_log_inter_time=self.mean_log_inter_time,
            std_log_inter_time=self.std_log_inter_time,
        )


class ExponentialTTELayer(nn.Module):
    """Exponential time-to-event head (fp32 product, as above)."""

    def __init__(self, in_dim):
        super().__init__()
        self.proj = nn.Linear(in_dim, 1)
        self.proj.keep_fp32 = True

    def forward(self, T, exact: bool = False):
        return Exponential(rate=elu_plus_one((exact_dense if exact else dense)(T, self.proj, torch.float32))[..., 0])


class GaussianIndexedRegressionLayer(nn.Module):
    """Multivariate regression head over an interleaved (mean, std) plane.

    Without ``idx`` (generation) it returns every target's Normal (its
    product through `ops.tensor_ops.exact_dense`). With
    ``idx`` ``(..., M)`` (training) it gathers the observed targets'
    parameters straight from the compute-dtype plane (mean at ``2 * idx``,
    std at ``2 * idx + 1``) and only then upcasts and activates, so the
    elementwise work and its backward run on ``(..., 2M)``, not on the
    ``(..., 2V)`` plane.
    """

    def __init__(self, in_dim, n_regression_targets, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Linear(in_dim, 2 * n_regression_targets)
        self.dtype = dtype

    def forward(self, X, idx=None):
        if idx is None:
            Z = exact_dense(X, self.proj, self.dtype).float()
            return Normal(loc=Z[..., 0::2], scale=elu_plus_one(Z[..., 1::2]))
        Z = dense(X, self.proj, self.dtype)
        m = idx.shape[-1]
        both = vocab_gather(Z, torch.cat([2 * idx, 2 * idx + 1], dim=-1).to(torch.int32))
        return Normal(loc=both[..., :m], scale=elu_plus_one(both[..., m:]))


class GaussianRegressionLayer(nn.Module):
    """Univariate probabilistic regression head."""

    def __init__(self, in_dim, dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Linear(in_dim, 2)
        self.dtype = dtype

    def forward(self, X):
        Z = dense(X, self.proj, self.dtype).float()
        return Normal(loc=Z[..., 0::2], scale=elu_plus_one(Z[..., 1::2]))
