"""Deterministic synthetic classification data (paper §6).

LIBSVM's a9a/ijcnn1/covtype are unavailable offline, so the paper-repro
runs use :func:`make_classification` — separable-with-noise Gaussian class
clusters with matched dimensionality — split 70/30 train/val and dealt
i.i.d. round-robin to nodes, exactly mirroring the paper's §6 protocol.

The counterpart of ``repro.data.synthetic``'s classification half. The
datasets, splits, shards and :class:`NodeSampler`'s batch stream come from
``np.random.default_rng`` exactly as the JAX package's do, so they are equal
bit for bit; :class:`NodeSampler` returns CPU tensors and the engine moves
them to its device. :func:`make_device_sampler` draws on the device from a
``torch.Generator`` instead of ``jax.random``, and so do :func:`lm_batch`,
the LM token stream, and the modality stubs :func:`audio_stub` and
:func:`vision_stub`: the JAX package's laws, other streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import DeviceSampler, Sampler
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Dataset:
    a: np.ndarray  # [n, d] features
    b: np.ndarray  # [n] int labels

    @property
    def n(self) -> int:
        return self.a.shape[0]


def make_classification(n: int = 8_000, d: int = 100, c: int = 2,
                        noise: float = 1.2, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(c, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, c, size=n)
    feats = centers[labels] + noise * rng.normal(size=(n, d))
    # mimic libsvm-style feature scaling
    feats /= np.abs(feats).max()
    return Dataset(feats.astype(np.float32), labels.astype(np.int32))


def train_val_split(ds: Dataset, val_frac: float = 0.3, seed: int = 0):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(ds.n)
    n_val = int(ds.n * val_frac)
    val, tr = perm[:n_val], perm[n_val:]
    return Dataset(ds.a[tr], ds.b[tr]), Dataset(ds.a[val], ds.b[val])


def shard_to_nodes(ds: Dataset, K: int) -> list[Dataset]:
    """Random, even, i.i.d. split to K participants (the paper's setting)."""
    per = ds.n // K
    return [Dataset(ds.a[k * per:(k + 1) * per], ds.b[k * per:(k + 1) * per])
            for k in range(K)]


def shard_to_nodes_noniid(ds: Dataset, K: int, alpha: float = 0.3,
                          seed: int = 0) -> list[Dataset]:
    """Dirichlet label-skewed split (the classic non-iid benchmark protocol).

    The paper assumes i.i.d. participants; this split serves a robustness
    ablation. ``alpha`` → ∞ recovers i.i.d.; small alpha concentrates each
    class on few nodes."""
    rng = np.random.default_rng(seed)
    classes = np.unique(ds.b)
    per = ds.n // K
    buckets: list[list[int]] = [[] for _ in range(K)]
    for c in classes:
        idx = np.flatnonzero(ds.b == c)
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * K)
        # cap so every node ends up with exactly n/K samples
        splits = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, splits)):
            buckets[k].extend(part.tolist())
    out = []
    for k in range(K):
        take = buckets[k]
        rng.shuffle(take)
        # pad/trim to equal size with replacement for even loads
        if len(take) < per:
            take = take + rng.choice(ds.n, per - len(take)).tolist()
        out.append(Dataset(ds.a[take[:per]], ds.b[take[:per]]))
    return out


class NodeSampler(Sampler):
    """Samples per-step {'f','g','h'} bilevel batches across K node datasets.

    f: validation batch, g: training batch (ζ0), h: J fresh training batches
    (ζ_1..ζ_J) — faithful to the paper's i.i.d. Neumann sampling.

    Draws come from a host-side numpy RNG in the JAX package's order (the
    generator argument is ignored), so the batches equal its bit for bit.
    They are CPU tensors; the engine moves them to its device, and its
    fused dispatch copies them into a CUDA graph's static buffers.
    """

    device_resident = False

    def __init__(self, train_nodes, val_nodes, batch: int, J: int,
                 seed: int = 0):
        self.tr, self.va = train_nodes, val_nodes
        self.batch, self.J = batch, J
        self.rng = np.random.default_rng(seed)

    def _draw(self, ds: Dataset, n: int):
        idx = self.rng.integers(0, ds.n, size=n)
        return ds.a[idx], ds.b[idx]

    def sample(self, _generator=None):
        K, B, J = len(self.tr), self.batch, self.J
        f = [self._draw(self.va[k], B) for k in range(K)]
        g = [self._draw(self.tr[k], B) for k in range(K)]
        h = [[self._draw(self.tr[k], B) for _ in range(J)] for k in range(K)]

        def stack(draws):
            return {"a": torch.from_numpy(np.stack([a for a, _ in draws])),
                    "b": torch.from_numpy(np.stack([b for _, b in draws]))}

        hs = [stack(hk) for hk in h]
        return {"f": stack(f), "g": stack(g),
                "h": {k: torch.stack([t[k] for t in hs]) for k in ("a", "b")}}

    def eval_batch(self, n: int = 2048):
        a = np.concatenate([d.a for d in self.va])[:n]
        b = np.concatenate([d.b for d in self.va])[:n]
        return {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}


def make_device_sampler(train_nodes: list[Dataset], val_nodes: list[Dataset],
                        batch: int, J: int, device="cuda") -> DeviceSampler:
    """Device-resident :class:`NodeSampler` equivalent.

    Node datasets live on ``device`` as (K, n_k, ·) stacks and every draw is
    uniform with replacement from the engine's batch generator, on the
    device: no host round trip per batch. The engine draws it outside the
    fused chunk's CUDA graph, one step at a time. Its stream differs from
    the JAX package's ``jax.random`` one.
    """
    dev = resolve_device(device)
    tr_a = torch.from_numpy(np.stack([d.a for d in train_nodes])).to(dev)
    tr_b = torch.from_numpy(np.stack([d.b for d in train_nodes])).to(dev)
    va_a = torch.from_numpy(np.stack([d.a for d in val_nodes])).to(dev)
    va_b = torch.from_numpy(np.stack([d.b for d in val_nodes])).to(dev)
    K = tr_a.shape[0]
    rows = torch.arange(K, device=dev)[:, None]

    def draw(gen, feats, labels, shape):
        idx = torch.randint(0, feats.shape[1], shape, generator=gen,
                            device=dev)
        node = rows.view((K,) + (1,) * (len(shape) - 1))
        return {"a": feats[node, idx], "b": labels[node, idx]}

    def sample(gen):
        return {"f": draw(gen, va_a, va_b, (K, batch)),
                "g": draw(gen, tr_a, tr_b, (K, batch)),
                "h": draw(gen, tr_a, tr_b, (K, J, batch))}

    return DeviceSampler(sample)


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def lm_batch(generator: torch.Generator, vocab: int, batch: int, seq: int, *,
             zipf_a: float = 1.2):
    """Zipf-ish token stream, drawn on the generator's device: a
    heavy-tailed marginal by an exponential race (ranks clipped to the
    vocabulary), each row shifted by its own draw from {0..6}. Returns
    ``{'tokens', 'labels'}``, int64 ``[batch, seq]``, the labels the tokens
    shifted by one. The JAX package draws the same distribution from
    ``jax.random``; the streams differ."""
    dev = generator.device
    u = torch.empty((batch, seq + 1), device=dev).exponential_(
        generator=generator)
    ranks = torch.clamp((u * vocab ** (1.0 / zipf_a)) ** zipf_a, 0, vocab - 1)
    shift = torch.randint(0, 7, (batch, 1), generator=generator, device=dev)
    toks = (ranks.long() + shift) % vocab
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def audio_stub(generator: torch.Generator, batch: int, frames: int,
               d_model: int, dtype=torch.float32):
    """Precomputed conv-frontend frame embeddings (the whisper stub):
    ``0.02 N(0, 1)`` ``[batch, frames, d_model]`` in ``dtype``, drawn on the
    generator's device."""
    return 0.02 * torch.randn((batch, frames, d_model), generator=generator,
                              device=generator.device, dtype=dtype)


def vision_stub(generator: torch.Generator, batch: int, n_tokens: int,
                d_model: int, seq: int, dtype=torch.float32):
    """Precomputed patch-token embeddings and their positions (the
    chameleon stub): ``0.02 N(0, 1)`` ``[batch, n_tokens, d_model]`` in
    ``dtype``, drawn on the generator's device, and positions
    ``arange(n_tokens)`` in every row (int32 ``[batch, n_tokens]``; ``seq``
    is unused, as in the JAX package)."""
    emb = 0.02 * torch.randn((batch, n_tokens, d_model), generator=generator,
                             device=generator.device, dtype=dtype)
    pos = torch.arange(n_tokens, dtype=torch.int32, device=generator.device)
    return emb, pos[None].repeat(batch, 1)
