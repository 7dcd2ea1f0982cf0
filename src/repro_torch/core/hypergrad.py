"""Stochastic hypergradient (Eq. 4 of the paper) for arbitrary pytrees.

The hypergradient of F(x) = f(x, y*(x)) is (Eq. 2/3)

    ∇F(x, y) = ∇_x f(x, y) − ∇²_{xy} g(x, y) [∇²_{yy} g(x, y)]^{-1} ∇_y f(x, y).

The inverse Hessian is approximated with the Ghadimi–Wang randomized Neumann
series (Eq. 4):

    H^{-1} ≈ (J / L_gy) Π_{j=1..J̃} (I − ∇²_{yy} g(x, y; ζ_j) / L_gy),   J̃ ~ U{0..J-1}

All second-order quantities are *matrix-free*:

* Hessian-vector products ``∇²_{yy} g · v`` use forward-over-reverse
  ``torch.func.jvp(torch.func.grad(g), (y,), (v,))``.
* The cross term ``∇²_{xy} g · v`` is ``∂/∂ε ∇_x g(x, y + εv)``, forward
  over reverse as well. The JAX package takes it reverse over reverse, as
  ``∇_x ⟨∇_y g(x, y), v⟩``; the mixed partials are the same. Reverse over
  reverse, the order in which the second pass summed x's many gradient
  contributions changed with what the process had run before (on the
  card, the last bit of an LM's cross term; the first pass's autograd
  nodes are made on another thread, with other sequence numbers), which
  broke fused == per_step. One reverse pass sums in a fixed order, and
  skips the second pass through the model.

The counterpart of ``repro.core.hypergrad``. The truncation level J̃ is an
integer tensor that the caller draws (the JAX package takes a PRNG key and
draws it here). The Neumann product runs a fixed J-term loop that keeps a
term only where ``j < J̃``, with no branch on data, so a step can be
captured as a CUDA graph. Trees go through ``torch.utils._pytree``, so a
parameter may be a tensor or a dict (or any registered container) of them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._pytree import tree_map

from repro_torch.core.problems import BilevelProblem

Params = Any
Batch = Any


@functools.lru_cache(maxsize=256)
def _rounded(c: float, dtype: torch.dtype) -> float:
    return torch.tensor(c, dtype=dtype).item()


def weak_scalar(c: float, a: torch.Tensor) -> float:
    """The Python float ``c`` as it meets the tensor ``a`` in the JAX
    package: JAX types a Python scalar weakly, so beside a bf16 array it is
    a bf16 constant (1/3 becomes 0.333984375) and each product rounds in
    bf16; torch keeps the scalar in f32. Rounding ``c`` to ``a``'s dtype
    first gives the JAX package's numbers; f32 and wider are unchanged."""
    return _rounded(float(c), a.dtype)


def tree_dot(a, b) -> torch.Tensor:
    """Σ over leaves of the f32-accumulated elementwise product."""
    leaves = pytree.tree_leaves(tree_map(
        lambda u, v: torch.sum(u * v, dtype=torch.float32), a, b))
    return functools.reduce(torch.add, leaves)


def tree_axpy(alpha, x, y):
    """alpha * x + y"""
    return tree_map(lambda u, v: alpha * u + v, x, y)


def tree_scale(alpha, x):
    return tree_map(lambda u: alpha * u, x)


def tree_sub(a, b):
    return tree_map(lambda u, v: u - v, a, b)


def tree_add(a, b):
    return tree_map(lambda u, v: u + v, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


@dataclasses.dataclass(frozen=True)
class HypergradConfig:
    """J: max Neumann terms. lip_gy: L_{g_y} scaling. randomize: use the
    caller's J̃ ~ U{0..J-1} (the paper's unbiased-in-expectation estimator)
    vs always all J terms (deterministic truncation — lower variance, same
    O((1−μ/L)^J) bias)."""

    J: int = 10
    lip_gy: float = 10.0
    randomize: bool = True


def hvp_yy(g: Callable, x: Params, y: Params, batch: Batch, v: Params) -> Params:
    """∇²_{yy} g(x, y; batch) · v via forward-over-reverse."""
    def grad_y(yy):
        return torch.func.grad(g, argnums=1)(x, yy, batch)
    return torch.func.jvp(grad_y, (y,), (v,))[1]


def jvp_xy(g: Callable, x: Params, y: Params, batch: Batch, v: Params) -> Params:
    """∇²_{xy} g(x, y; batch) · v  =  ∂/∂ε ∇_x g(x, y + εv; batch)."""
    def grad_x(yy):
        return torch.func.grad(g, argnums=0)(x, yy, batch)
    return torch.func.jvp(grad_x, (y,), (tree_map(torch.Tensor.detach, v),))[1]


def draw_jtilde(cfg: HypergradConfig, shape, generator: torch.Generator
                ) -> torch.Tensor:
    """J̃ ~ U{0..J-1} of the given shape (int64, on the generator's device).

    The paper writes J̃ ∈ {0..J}; Lemma 2's identity
    E[(J/L)Π_{j<=J̃}] = (1/L)Σ_{j=0}^{J-1}(I − H/L)^j requires J̃ uniform
    over J values, i.e. {0..J-1} (as in Ghadimi & Wang 2018, and as the JAX
    package draws it)."""
    return torch.randint(0, max(cfg.J, 1), shape, generator=generator,
                         device=generator.device)


def neumann_inverse_hvp(g: Callable, x: Params, y: Params, v: Params,
                        hbatches: Batch, cfg: HypergradConfig,
                        jtilde: torch.Tensor | None) -> Params:
    """(J/L) Π_{j<=J̃} (I − H(ζ_j)/L) v  — the randomized Neumann product.

    ``hbatches`` is a pytree whose leaves have a leading axis of length J (one
    minibatch per Neumann term ζ_1..ζ_J; the paper draws them i.i.d.).
    ``jtilde`` is the integer truncation level, a 0-d tensor; with
    ``cfg.randomize=False`` it is ignored and all J terms apply.
    """
    J, L = cfg.J, cfg.lip_gy
    if J == 0:
        return tree_scale(0.0, v)
    if cfg.randomize and jtilde is None:
        raise ValueError("randomize=True needs the truncation level jtilde")

    acc = v
    for j in range(J):
        batch_j = tree_map(lambda b: b[j], hbatches)
        hv = hvp_yy(g, x, y, batch_j, acc)
        new = tree_sub(acc, tree_scale(1.0 / L, hv))
        if cfg.randomize:  # only apply the factor while j < J̃
            keep = jtilde > j
            new = tree_map(lambda n, a: torch.where(keep, n, a), new, acc)
        acc = new
    return tree_scale(J / L, acc)


def stochastic_hypergrad(problem: BilevelProblem, cfg: HypergradConfig,
                         x: Params, y: Params, fbatch: Batch, gbatch: Batch,
                         hbatches: Batch, jtilde: torch.Tensor | None
                         ) -> Params:
    """∇̃F^{(k)}(x, y; ξ̃) of Eq. (4).

    fbatch: ξ for ∇_x f / ∇_y f;  gbatch: ζ_0 for the Jacobian term;
    hbatches: ζ_1..ζ_J stacked for the Neumann product; jtilde: J̃.
    """
    f, g = problem.upper_loss, problem.lower_loss
    gx, gy = torch.func.grad(f, argnums=(0, 1))(x, y, fbatch)
    ihvp = neumann_inverse_hvp(g, x, y, gy, hbatches, cfg, jtilde)
    cross = jvp_xy(g, x, y, gbatch, ihvp)
    return tree_sub(gx, cross)


def expected_hypergrad(problem: BilevelProblem, cfg: HypergradConfig,
                       x: Params, y: Params, batch: Batch) -> Params:
    """Deterministic ∇̃F (Eq. 5) with the *full-batch* losses and the
    deterministic J-term Neumann sum (1/L) Σ_{j<J} (I − H/L)^j. Test oracle."""
    f, g = problem.upper_loss, problem.lower_loss
    gx, gy = torch.func.grad(f, argnums=(0, 1))(x, y, batch)
    L, J = cfg.lip_gy, cfg.J

    acc, power = tree_zeros_like(gy), gy  # power = (I - H/L)^j v
    for _ in range(J):
        acc = tree_add(acc, power)
        hv = hvp_yy(g, x, y, batch, power)
        power = tree_sub(power, tree_scale(1.0 / L, hv))
    ihvp = tree_scale(1.0 / L, acc)
    cross = jvp_xy(g, x, y, batch, ihvp)
    return tree_sub(gx, cross)


def ravel_pytree(tree) -> tuple[torch.Tensor, Callable]:
    """A tree's leaves flattened into one vector, and the inverse map."""
    leaves, spec = pytree.tree_flatten(tree)
    shapes = [t.shape for t in leaves]
    sizes = [t.numel() for t in leaves]

    def unravel(flat):
        parts = torch.split(flat, sizes)
        return pytree.tree_unflatten(
            [p.reshape(s) for p, s in zip(parts, shapes)], spec)

    return torch.cat([t.reshape(-1) for t in leaves]), unravel


def exact_hypergrad_dense(problem: BilevelProblem, x: torch.Tensor,
                          y: Params, batch: Batch) -> Params:
    """Exact Eq. (3) via dense Hessian materialization. Small problems only."""
    f, g = problem.upper_loss, problem.lower_loss
    yflat, unrav = ravel_pytree(y)

    def g_flat(xx, yf):
        return g(xx, unrav(yf), batch)

    H = torch.func.hessian(g_flat, argnums=1)(x, yflat)
    gy = torch.func.grad(f, argnums=1)(x, y, batch)
    v = torch.linalg.solve(H, ravel_pytree(gy)[0])
    cross = jvp_xy(g, x, y, batch, unrav(v))
    gx = torch.func.grad(f, argnums=0)(x, y, batch)
    return tree_sub(gx, cross)
