"""Distribution-producing emission heads (TTE + regression), generation path.

Counterpart: ``eventstreamgpt_tpu/models/generative_layers.py``. The
strided slices of the projection output are kept exactly: ``0::3`` /
``1::3`` / ``2::3`` for the lognormal mixture, ``0::2`` / ``1::2`` for
Gaussian heads; the positive transform is ``ELU + 1 + finfo.tiny``. Only the
``idx=None`` (generation) path of the indexed regression head is ported;
the indexed training path (the ``vocab_gather`` kernel) comes with training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributions import Exponential, LogNormalMixture, Normal
from ..ops.tensor_ops import dense


def elu_plus_one(x: torch.Tensor) -> torch.Tensor:
    """ELU(x) + 1 + tiny: strictly positive."""
    return F.elu(x) + 1.0 + torch.finfo(x.dtype).tiny


class LogNormalMixtureTTELayer(nn.Module):
    """Lognormal-mixture time-to-event head.

    The flax layer has no ``dtype``, so its product runs in fp32 even under
    bf16 precision; ``proj`` is marked to stay fp32 when the model casts.
    """

    def __init__(self, in_dim, num_components, mean_log_inter_time=0.0, std_log_inter_time=1.0):
        super().__init__()
        self.proj = nn.Linear(in_dim, 3 * num_components)
        self.proj.keep_fp32 = True
        self.mean_log_inter_time = mean_log_inter_time
        self.std_log_inter_time = std_log_inter_time

    def forward(self, T):
        p = dense(T, self.proj).float()
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

    def forward(self, T):
        return Exponential(rate=elu_plus_one(dense(T, self.proj).float())[..., 0])


class GaussianIndexedRegressionLayer(nn.Module):
    """Multivariate regression head; generation returns every target's Normal."""

    def __init__(self, in_dim, n_regression_targets):
        super().__init__()
        self.proj = nn.Linear(in_dim, 2 * n_regression_targets)

    def forward(self, X, idx=None):
        if idx is not None:
            raise ValueError("the indexed (training) regression path is not ported yet")
        Z = dense(X, self.proj).float()
        return Normal(loc=Z[..., 0::2], scale=elu_plus_one(Z[..., 1::2]))


class GaussianRegressionLayer(nn.Module):
    """Univariate probabilistic regression head."""

    def __init__(self, in_dim):
        super().__init__()
        self.proj = nn.Linear(in_dim, 2)

    def forward(self, X):
        Z = dense(X, self.proj).float()
        return Normal(loc=Z[..., 0::2], scale=elu_plus_one(Z[..., 1::2]))
