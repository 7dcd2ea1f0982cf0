"""The moe, vlm and audio families' kernel shapes and serving paths on the
card. JAX-free, so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_families_cuda.py

The verify-window kernel at windows past one 64-row tile (Q 9 over G 8,
Q 16 over G 4) and the flash kernel at whisper-tiny's encoder and
cross-attention shapes, against their plain versions; a reduced MoE paged
drain (every decode step's MoE routed per slot) and a reduced whisper
continuous drain on the card against the same drains on the CPU. Every
test skips without a card (the kernels have no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import (attention_ref, flash_attention,  # noqa: E402
                                 paged_attention, paged_attention_multi,
                                 paged_attention_multi_ref)
from torch_paged_cases import (TOL_F32, bf16_excess, multi_case,  # noqa: E402
                               window_lengths)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def check_close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    if out.dtype == torch.float32:
        assert float((out - ref).abs().max()) < TOL_F32
    else:
        assert bf16_excess(out.float().cpu(), ref.float().cpu()) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,H,Hkv,Dh,bs", [
    (9, 64, 8, 128, 16),    # chameleon-34b's heads at k = 8: 72 rows
    (16, 16, 4, 64, 8),     # 64 rows at the tile's edge, Q past 8
    (16, 32, 4, 64, 8),     # G 8: two full tiles of 64
    (12, 24, 2, 32, 4),     # G 12: 144 rows, a partial third tile
])
def test_cuda_multi_kernel_any_window(cuda_device, dtype, Q, H, Hkv, Dh, bs):
    case = multi_case(Q * H + Dh, lengths=window_lengths(Q, bs) + [2], Q=Q,
                      H=H, Hkv=Hkv, Dh=Dh, L=2, bs=bs)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, kp, vp, tables, lengths, 1)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    check_close(out, paged_attention_multi_ref(q, kp, vp, tables, lengths,
                                               1))
    assert float(out[3].abs().max()) == 0.0             # the dead slot
    assert float(out[5, :Q - 2].abs().max()) == 0.0     # rows seeing nothing


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv", [(1500, 1500), (300, 1500), (37, 1500)],
                         ids=["encoder", "cross", "cross short"])
def test_cuda_flash_whisper_shapes(cuda_device, dtype, Sq, Skv):
    """whisper-tiny's encoder (S 1 500, full) and its prefill
    cross-attention (the prompt over 1 500 frames, full): 6 heads of 64."""
    g = torch.Generator().manual_seed(Sq)
    q, k, v = (torch.randn(shape, generator=g).to(cuda_device, dtype)
               for shape in ((1, 6, Sq, 64), (1, 6, Skv, 64),
                             (1, 6, Skv, 64)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    check_close(out, attention_ref(q, k, v, causal=False))


def serve_on(device, cfg, params, reqs, **kw):
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, b) for p, b in reqs]
    before = (paged_attention.launches, flash_attention.launches)
    res = eng.run()
    counts = (paged_attention.launches - before[0],
              flash_attention.launches - before[1])
    return [res[r] for r in rids], eng.stats, counts


@pytest.mark.cuda
def test_cuda_moe_paged_drain_matches_cpu(cuda_device):
    """A reduced phi3.5-moe paged drain in f32 (TF32 off) gives the CPU
    drain's streams on the card, with the decode kernel once per layer per
    decode step and no token dropped by any slot's routing."""
    from repro_torch.configs import get
    from repro_torch.models import init_params, moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("phi3.5-moe-42b-a6.6b").reduced().with_overrides(
        n_heads=4, n_kv_heads=2, head_dim=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 10)
            for n in rng.integers(3, 30, size=6)]
    route, dropped = moe.route, []

    def watched(c, p, flat):
        r = route(c, p, flat)
        if flat.shape[1] == 1:      # per-slot routing of a decode step
            dropped.append(int((~r["keep"]).sum()))
        return r

    moe.route = watched
    try:
        runs = [serve_on(d, cfg, params, reqs, mode="paged", capacity=48,
                         max_batch=4, block_size=8, num_blocks=16)
                for d in ("cpu", cuda_device)]
    finally:
        moe.route = route
    (cpu, _, _), (card, st, counts) = runs
    assert card == cpu
    assert counts[0] == cfg.n_layers * st["decode_steps"] > 0
    assert dropped and sum(dropped) == 0


@pytest.mark.cuda
def test_cuda_whisper_continuous_drain_matches_cpu(cuda_device):
    """A reduced whisper-tiny continuous drain in f32 (TF32 off): the CPU
    drain's streams, with the flash kernel at the encoder of the slot
    cache's init, and at every prefill's encoder, self- and
    cross-attention."""
    from repro_torch.configs import get
    from repro_torch.models import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("whisper-tiny").reduced().with_overrides(src_len=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 8)
            for n in rng.integers(3, 20, size=5)]
    (cpu, _, _), (card, st, counts) = [
        serve_on(d, cfg, params, reqs, mode="continuous", capacity=48,
                 max_batch=3) for d in ("cpu", cuda_device)]
    assert card == cpu
    assert counts[1] == cfg.n_enc_layers * (1 + st["prefills"]) \
        + 2 * cfg.n_layers * st["prefills"]
