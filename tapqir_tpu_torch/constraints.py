"""Constraint transforms between unconstrained optimizer space and parameter
space (counterpart of tapqir_tpu/constraints.py).

The clamps change values, so they match the JAX package exactly: the exp
exponent is clipped at +-30, the sigmoid at [1e-6, 1 - 1e-6], and simplex is
a softmax whose inverse is the log of the normalized probabilities.
"""

from dataclasses import dataclass
from typing import Callable

import torch

# see tapqir_tpu/constraints.py for why each clamp exists
_EXP_CLAMP = 30.0
_SIGMOID_EPS = 1e-6


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


@dataclass(frozen=True)
class Transform:
    """Bijective map unconstrained -> constrained (and back for init)."""

    forward: Callable
    inverse: Callable
    name: str = ""

    def __call__(self, u):
        return self.forward(u)


def _bounded_exp(u):
    return torch.exp(torch.clamp(u, -_EXP_CLAMP, _EXP_CLAMP))


def _bounded_sigmoid(u):
    return torch.clamp(torch.sigmoid(u), _SIGMOID_EPS, 1.0 - _SIGMOID_EPS)


def positive() -> Transform:
    return Transform(_bounded_exp, torch.log, "positive")


def unit_interval() -> Transform:
    return Transform(_bounded_sigmoid, _logit, "unit_interval")


def interval(low: float, high: float) -> Transform:
    width = high - low

    def fwd(u):
        return low + width * _bounded_sigmoid(u)

    def inv(x):
        return _logit((x - low) / width)

    return Transform(fwd, inv, f"interval({low},{high})")


def greater_than(lb: float) -> Transform:
    def fwd(u):
        return lb + _bounded_exp(u)

    def inv(x):
        return torch.log(x - lb)

    return Transform(fwd, inv, f"greater_than({lb})")


def simplex() -> Transform:
    def fwd(u):
        return torch.softmax(u, dim=-1)

    def inv(x):
        return torch.log(x / x.sum(-1, keepdim=True))

    return Transform(fwd, inv, "simplex")


def identity() -> Transform:
    return Transform(lambda u: u, lambda x: x, "identity")
