"""Trace-time activation-sharding hints: the counterpart of
``repro.sharding.hints``.

The launcher activates hints around a step (``with hints(act=P(...))``)
and :func:`current` reads them; the dry run records them beside its
result. In the JAX package ``constrain(x, name)`` becomes
``with_sharding_constraint`` under an active hint. The port executes no
DTensor program yet (``ROADMAP.md``, queue 1, item 6), so there is nothing
to constrain: :func:`constrain` returns a plain tensor as it is, and the
port's models do not call it.
"""
from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


def current() -> dict:
    return getattr(_tls, "hints", {})


@contextlib.contextmanager
def hints(**kw):
    old = current()
    _tls.hints = {**old, **{k: v for k, v in kw.items() if v is not None}}
    try:
        yield
    finally:
        _tls.hints = old


def constrain(x, name: str):
    """``x`` itself: a plain tensor carries no placement to constrain."""
    del name
    return x
