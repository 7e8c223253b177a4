"""Probability distributions for the generative heads, on tensors.

Counterpart: ``eventstreamgpt_tpu/distributions.py`` (Categorical,
Bernoulli, Normal, Exponential, LogNormalMixture) with the same
parameterizations and log-densities (``log_prob``, which the training
losses read).
``sample(generator)`` draws with an explicit source of uniform noise: a
``torch.Generator``, or any object with a ``uniform(shape) -> Tensor``
method (the serving engine passes
`generation.sampling.RowStreams`, a per-row counter-based stream). A
distribution never reads global random state. Each also carries its greedy
statistic (``greedy()``): the categorical mode, the Bernoulli ``p >= 0.5``
indicator, the mean of a continuous head.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

# Open-interval clamp for uniforms drawn from a torch.Generator (log(0) guards).
_U_EPS = 2.0**-25


def uniform(generator, shape, device) -> torch.Tensor:
    """fp32 uniforms in (0, 1) of ``shape`` from ``generator``."""
    if isinstance(generator, torch.Generator):
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return u.clamp(_U_EPS, 1.0 - _U_EPS)
    return generator.uniform(shape)


def gumbel(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(generator, shape, device)))


def standard_normal(generator, shape, device) -> torch.Tensor:
    """Standard normal noise by the Box-Muller transform (two uniforms)."""
    u1 = uniform(generator, shape, device)
    u2 = uniform(generator, shape, device)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


@dataclasses.dataclass
class Categorical:
    """A categorical distribution over the last axis of ``logits``."""

    logits: torch.Tensor

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """Log-probability of integer labels; an out-of-range label reads the
        nearest class (JAX's ``mode="clip"`` gather)."""
        idx = value.long().clamp(0, self.logits.shape[-1] - 1)
        return torch.gather(torch.log_softmax(self.logits, dim=-1), -1, idx[..., None])[..., 0]

    def sample(self, generator) -> torch.Tensor:
        g = gumbel(generator, self.logits.shape, self.logits.device).to(self.logits.dtype)
        return torch.argmax(g + self.logits, dim=-1).to(torch.int32)

    def greedy(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class Bernoulli:
    """An elementwise Bernoulli distribution parameterized by logits."""

    logits: torch.Tensor

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """-BCE with logits: ``v * log sigmoid(l) + (1 - v) * log sigmoid(-l)``."""
        value = value.to(self.logits.dtype)
        return value * F.logsigmoid(self.logits) + (1 - value) * F.logsigmoid(-self.logits)

    def sample(self, generator) -> torch.Tensor:
        u = uniform(generator, self.logits.shape, self.logits.device)
        return (u < self.probs).to(torch.float32)

    def greedy(self) -> torch.Tensor:
        return (self.probs >= 0.5).to(torch.float32)


@dataclasses.dataclass
class Normal:
    """An elementwise Gaussian."""

    loc: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        var = self.scale**2
        return -((value - self.loc) ** 2) / (2 * var) - torch.log(self.scale) - 0.5 * math.log(2 * math.pi)

    def sample(self, generator) -> torch.Tensor:
        z = standard_normal(generator, self.loc.shape, self.loc.device).to(self.loc.dtype)
        return self.loc + self.scale * z

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    def greedy(self) -> torch.Tensor:
        return self.mean


@dataclasses.dataclass
class Exponential:
    """An elementwise exponential distribution with rate parameterization."""

    rate: torch.Tensor

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        return torch.log(self.rate) - self.rate * value

    def sample(self, generator) -> torch.Tensor:
        u = uniform(generator, self.rate.shape, self.rate.device).to(self.rate.dtype)
        return -torch.log(u) / self.rate

    @property
    def mean(self) -> torch.Tensor:
        return 1.0 / self.rate

    def greedy(self) -> torch.Tensor:
        return self.mean


@dataclasses.dataclass
class LogNormalMixture:
    """Mixture-of-lognormals TTE distribution (Shchur et al. parameterization).

    Components are Gaussians over ``z = (log(t) - mean_log_inter_time) /
    std_log_inter_time``; ``locs``/``log_scales``/``log_weights`` are
    ``(..., K)``, the two time statistics are python floats.
    """

    locs: torch.Tensor
    log_scales: torch.Tensor
    log_weights: torch.Tensor
    mean_log_inter_time: float = 0.0
    std_log_inter_time: float = 1.0

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        """The mixture's density over ``z`` with the Jacobian ``1 / (t * std)``;
        ``t`` is clamped below at the smallest normal float (``log(0)`` guard)."""
        value = torch.clamp(value, min=torch.finfo(self.locs.dtype).tiny)
        log_t = torch.log(value)
        z = (log_t - self.mean_log_inter_time) / self.std_log_inter_time
        comp = Normal(self.locs, torch.exp(self.log_scales)).log_prob(z[..., None])
        gmm = torch.logsumexp(torch.log_softmax(self.log_weights, dim=-1) + comp, dim=-1)
        return gmm - log_t - math.log(self.std_log_inter_time)

    def sample(self, generator) -> torch.Tensor:
        comps = Normal(self.locs, torch.exp(self.log_scales)).sample(generator)  # (..., K)
        choice = Categorical(self.log_weights).sample(generator).long()
        z = torch.gather(comps, -1, choice[..., None])[..., 0]
        return torch.exp(z * self.std_log_inter_time + self.mean_log_inter_time)

    @property
    def mean(self) -> torch.Tensor:
        """E[t] = sum_k w_k * exp(mu'_k + sigma'_k**2 / 2) in original time units."""
        w = torch.softmax(self.log_weights, dim=-1)
        mu = self.locs * self.std_log_inter_time + self.mean_log_inter_time
        sigma = torch.exp(self.log_scales) * self.std_log_inter_time
        return (w * torch.exp(mu + sigma**2 / 2)).sum(dim=-1)

    def greedy(self) -> torch.Tensor:
        return self.mean


def dist_tensors(dist) -> list[torch.Tensor]:
    """The tensor parameters of a distribution (the health sentinel scans them)."""
    return [getattr(dist, f.name) for f in dataclasses.fields(dist) if torch.is_tensor(getattr(dist, f.name))]


def dist_map(dist, fn):
    """A copy of ``dist`` with ``fn`` applied to every tensor parameter."""
    return dataclasses.replace(
        dist,
        **{
            f.name: fn(getattr(dist, f.name))
            for f in dataclasses.fields(dist)
            if torch.is_tensor(getattr(dist, f.name))
        },
    )
