"""LM step batches for the decentralized bilevel trainer.

Builds the trainer's step batches — ``{'f','g','h'}`` with node axis K and
the J axis on 'h' — from a ``torch.Generator`` on its own device, so
:func:`make_device_lm_sampler` returns a
:class:`repro_torch.core.engine.DeviceSampler` that draws on the engine's
device from the engine's batch generator. The engine draws it outside the
fused chunk's CUDA graph, one step at a time, and copies each batch into the
graph's static buffers.

The counterpart of ``repro.data.lm``, which draws from ``jax.random`` keys:
the distribution is the same, the streams differ. The vlm and audio
families' modality extras wait on the training half of those families
(``ROADMAP.md``, queue 1, item 4).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import DeviceSampler
from repro_torch.data.synthetic import lm_batch
from repro_torch.models.config import ModelConfig


def lm_batch_extras(cfg: ModelConfig, generator: torch.Generator, batch: int,
                    seq: int) -> dict:
    """Modality extras of a node batch: none for the dense, hybrid and ssm
    families."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's batch extras wait on the "
            "training half of the vlm and audio families (ROADMAP.md, queue "
            "1, item 4)")
    return {}


def make_node_batch(cfg: ModelConfig, generator: torch.Generator,
                    per_node: int, seq: int) -> dict:
    """One node's batch: ``{'tokens', 'labels'}`` ``[per_node, seq]``."""
    b = lm_batch(generator, cfg.vocab, per_node, seq)
    b.update(lm_batch_extras(cfg, generator, per_node, seq))
    return b


def make_lm_step_batch(cfg: ModelConfig, generator: torch.Generator, K: int,
                       per_node: int, seq: int, *, J: int) -> dict:
    """{'f','g','h'} with node axis K: leaves ``[K, per_node, seq]`` on 'f'
    and 'g', ``[K, J, per_node, seq]`` on 'h'. Every row is an independent
    draw, so the J Hessian minibatches ζ_1..ζ_J are i.i.d. and independent
    of the ξ/ζ0 draws, as Eq. 4 requires; each of the three is one draw of
    all its rows."""
    def draw(*lead):
        n = 1
        for d in lead:
            n *= d
        b = make_node_batch(cfg, generator, n * per_node, seq)
        return {k: t.reshape(*lead, per_node, seq) for k, t in b.items()}

    return {"f": draw(K), "g": draw(K), "h": draw(K, J)}


def make_device_lm_sampler(cfg: ModelConfig, tc, K: int, per_node: int,
                           seq: int) -> DeviceSampler:
    """Sampler of :func:`make_lm_step_batch` batches, drawn on the device of
    the generator the engine hands it. ``tc`` is anything with ``.J``
    (e.g. :class:`repro_torch.train.TrainerConfig`)."""
    J = int(tc.J)
    return DeviceSampler(
        lambda generator: make_lm_step_batch(cfg, generator, K, per_node,
                                             seq, J=J))
