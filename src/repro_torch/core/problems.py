"""Bilevel problem containers + the paper's concrete problems.

A :class:`BilevelProblem` bundles the per-node upper objective ``f(x, y, batch)``
and lower objective ``g(x, y, batch)``. Both are *per-node* scalar losses; the
global objective is the average over nodes (Eq. 1 of the paper).

Two concrete instances:

* :func:`quadratic_problem` — strongly-convex-quadratic lower level with an
  analytic ``y*(x)`` and hypergradient, used by the tests as an oracle.
* :func:`logreg_hyperopt` — the paper's §6 experiment (Eq. 19): hyperparameter
  optimization of an L2-regularized softmax regression, where the upper level
  learns per-feature regularization strengths ``exp(x_q)`` on a validation set.

The counterpart of ``repro.core.problems``. ``init_x``/``init_y`` take a
``torch.Generator`` and a device instead of a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device

Batch = Any
Params = Any


@dataclasses.dataclass(frozen=True)
class BilevelProblem:
    """f/g take (x, y, batch) -> scalar. init_*(generator, device) build
    per-node parameters."""

    upper_loss: Callable[[Params, Params, Batch], torch.Tensor]
    lower_loss: Callable[[Params, Params, Batch], torch.Tensor]
    init_x: Callable[[torch.Generator, torch.device], Params]
    init_y: Callable[[torch.Generator, torch.device], Params]
    # L_{g_y}: Lipschitz constant of ∇_y g, used by the Neumann series (Eq. 4).
    lip_gy: float = 1.0
    # μ: strong-convexity constant of g in y (Assumption 2). Diagnostic only.
    mu: float = 0.1


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draws from ``gen`` (on its own device), moved to
    ``device``: a CPU generator gives the CPU and the card the same draw."""
    return torch.randn(shape, generator=gen,
                       device=gen.device).to(device)


# ---------------------------------------------------------------------------
# Quadratic bilevel problem with analytic solution (test oracle)
# ---------------------------------------------------------------------------

def quadratic_from_arrays(A, B, b, c, noise: float = 0.0, mu: float = 0.5,
                          L: float = 2.0, device="cuda"
                          ) -> tuple[BilevelProblem, dict]:
    """g(x,y) = 1/2 y^T A y - y^T (B x + b),  f(x,y) = 1/2 |y - c|^2 + 1/2 |x|^2,
    built from given arrays (A SPD with eigenvalues in [mu, L]), placed on
    ``device``.

    y*(x) = A^{-1} (B x + b);   ∇F(x) = x + B^T A^{-1} (y*(x) - c).
    ``batch`` is the shift of b itself, a ``[dy]`` tensor (``None``: no
    shift). The JAX package's batch is a PRNG key from which it draws the
    shift; here the caller draws it, with the oracle's ``draw_shift``
    (``noise`` × a standard normal, zero when ``noise`` is 0).
    """
    dev = resolve_device(device)
    A, B, b, c = (torch.as_tensor(t, dtype=torch.float32).to(dev)
                  for t in (A, B, b, c))
    dy, dx = B.shape

    def lower_loss(x, y, batch):
        bb = b if batch is None else b + batch
        return 0.5 * y @ A @ y - y @ (B @ x + bb)

    def upper_loss(x, y, batch):
        return 0.5 * torch.sum((y - c) ** 2) + 0.5 * torch.sum(x ** 2)

    def y_star(x):
        return torch.linalg.solve(A, B @ x + b)

    def hypergrad(x):
        return x + B.T @ torch.linalg.solve(A, y_star(x) - c)

    def x_star():
        Ainv = torch.linalg.inv(A)
        M = torch.eye(dx, device=dev) + B.T @ Ainv @ Ainv @ B
        rhs = -B.T @ Ainv @ (Ainv @ b - c)
        return torch.linalg.solve(M, rhs)

    def draw_shift(gen: torch.Generator):
        """One batch: ``noise`` × a standard normal ``[dy]`` draw."""
        return noise * _normal(gen, (dy,), dev)

    prob = BilevelProblem(
        upper_loss=upper_loss,
        lower_loss=lower_loss,
        init_x=lambda gen, device: _normal(gen, (dx,), device),
        init_y=lambda gen, device: _normal(gen, (dy,), device),
        lip_gy=float(L),
        mu=float(mu),
    )
    oracle = {"A": A, "B": B, "b": b, "c": c, "y_star": y_star,
              "hypergrad": hypergrad, "x_star": x_star,
              "draw_shift": draw_shift}
    return prob, oracle


def quadratic_problem(dx: int = 4, dy: int = 6, seed: int = 0,
                      noise: float = 0.0, device="cuda"
                      ) -> tuple[BilevelProblem, dict]:
    """:func:`quadratic_from_arrays` with A, B, b and c drawn from a CPU
    ``torch.Generator`` seeded with ``seed``: A = Q diag(linspace(μ, L)) Q^T
    with Q orthogonal, μ = 0.5, L = 2. (The JAX package draws them from its
    PRNG; a parity test builds both problems from its oracle's arrays.)"""
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn((dy, dy), generator=gen))
    mu, L = 0.5, 2.0
    A = Q @ torch.diag(torch.linspace(mu, L, dy)) @ Q.T
    B = torch.randn((dy, dx), generator=gen) / dx ** 0.5
    b = torch.randn((dy,), generator=gen)
    c = torch.randn((dy,), generator=gen)
    return quadratic_from_arrays(A, B, b, c, noise=noise, mu=mu, L=L,
                                 device=device)


# ---------------------------------------------------------------------------
# The paper's §6 experiment: logistic-regression hyperparameter optimization
# ---------------------------------------------------------------------------

def _softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def logreg_hyperopt(d: int, c: int = 2, lip_gy: float = 10.0,
                    mu: float = 1e-3) -> BilevelProblem:
    """Eq. (19): y ∈ R^{d×c} model weights, x ∈ R^d per-feature log-reg-strengths.

    lower g = CE(train) + (1/(c d)) Σ_{p,q} exp(x_q) y_{qp}^2
    upper f = CE(val)

    ``batch`` is a dict with 'a' (features [n, d]) and 'b' (labels [n]) — the
    caller supplies a training batch for g and a validation batch for f.
    """

    def lower_loss(x, y, batch):
        logits = batch["a"] @ y
        reg = torch.mean(torch.exp(x)[:, None] * y ** 2)
        return _softmax_xent(logits, batch["b"]) + reg

    def upper_loss(x, y, batch):
        logits = batch["a"] @ y
        return _softmax_xent(logits, batch["b"])

    return BilevelProblem(
        upper_loss=upper_loss,
        lower_loss=lower_loss,
        init_x=lambda gen, device: torch.zeros((d,), device=device),
        init_y=lambda gen, device: 0.01 * _normal(gen, (d, c), device),
        lip_gy=lip_gy,
        mu=mu,
    )


def accuracy(y: torch.Tensor, batch: Batch) -> torch.Tensor:
    pred = torch.argmax(batch["a"] @ y, dim=-1)
    return torch.mean((pred == batch["b"]).to(torch.float32))
