"""LM step batches for the decentralized bilevel trainer.

Builds the trainer's step batches — ``{'f','g','h'}`` with node axis K and
the J axis on 'h' — from a ``torch.Generator`` on its own device, so
:func:`make_device_lm_sampler` returns a
:class:`repro_torch.core.engine.DeviceSampler` that draws on the engine's
device from the engine's batch generator. The engine draws it outside the
fused chunk's CUDA graph, one step at a time, and copies each batch into the
graph's static buffers.

The counterpart of ``repro.data.lm``, which draws from ``jax.random`` keys:
the distribution is the same, the streams differ; so for the vlm and
audio families' modality extras (:func:`lm_batch_extras`).
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import DeviceSampler
from repro_torch.data.synthetic import audio_stub, lm_batch, vision_stub
from repro_torch.models.config import ModelConfig


def lm_batch_extras(cfg: ModelConfig, generator: torch.Generator, batch: int,
                    seq: int) -> dict:
    """Modality extras of a node batch: the vlm family's ``image_embeds``
    ``[batch, n, d_model]`` and ``image_pos`` ``[batch, n]`` with ``n =
    min(n_img_tokens, seq)``, the audio family's ``src_embeds`` ``[batch,
    src_len, d_model]``, in ``cfg.dtype``; none for the other families."""
    extras = {}
    if cfg.family == "vlm":
        n = min(cfg.n_img_tokens, seq)
        extras["image_embeds"], extras["image_pos"] = vision_stub(
            generator, batch, n, cfg.d_model, seq, dtype=cfg.dtype)
    if cfg.family == "audio":
        extras["src_embeds"] = audio_stub(generator, batch, cfg.src_len,
                                          cfg.d_model, dtype=cfg.dtype)
    return extras


def make_node_batch(cfg: ModelConfig, generator: torch.Generator,
                    per_node: int, seq: int) -> dict:
    """One node's batch: ``{'tokens', 'labels'}`` ``[per_node, seq]`` and
    the family's extras (:func:`lm_batch_extras`), each with leading axis
    ``per_node``."""
    b = lm_batch(generator, cfg.vocab, per_node, seq)
    b.update(lm_batch_extras(cfg, generator, per_node, seq))
    return b


def make_lm_step_batch(cfg: ModelConfig, generator: torch.Generator, K: int,
                       per_node: int, seq: int, *, J: int) -> dict:
    """{'f','g','h'} with node axis K: leaves ``[K, per_node, ...]`` on 'f'
    and 'g', ``[K, J, per_node, ...]`` on 'h' (``...`` is ``seq`` for the
    tokens and labels, the extras' own trailing shape for theirs). Every
    row is an independent draw, so the J Hessian minibatches ζ_1..ζ_J are
    i.i.d. and independent of the ξ/ζ0 draws, as Eq. 4 requires; each of
    the three is one draw of all its rows."""
    def draw(*lead):
        n = 1
        for d in lead:
            n *= d
        b = make_node_batch(cfg, generator, n * per_node, seq)
        return {k: t.reshape(*lead, per_node, *t.shape[1:])
                for k, t in b.items()}

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
