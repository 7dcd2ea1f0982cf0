"""repro_torch — the PyTorch/CUDA port of the ``repro`` package for one
NVIDIA H100.

The port grows slice by slice beside the JAX package (see ``ROADMAP.md``).
Module names mirror ``repro``'s, so each file has an obvious counterpart.
It imports ``torch`` and numpy only, never ``jax`` or anything of ``repro``.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).
"""
