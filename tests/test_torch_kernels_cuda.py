"""The port's CUDA paged-attention kernel vs its plain PyTorch version, on
the card. JAX-free, so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_kernels_cuda.py

Every test skips without a card (the kernel has no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention, paged_attention_ref  # noqa: E402
from torch_paged_cases import TOL_F32, bf16_excess, paged_case, tail_lengths  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,H,Hkv,Dh,alias,n_pages", [
    (4, 4, 4, 64, False, None),
    (16, 15, 5, 64, True, None),     # smollm-360m's heads, shared prefix
    (16, 15, 5, 64, False, 8),       # table wider than the live pages
    (128, 6, 2, 64, False, None),
    (8, 16, 1, 128, False, None),    # >48 KB of shared memory per block
])
def test_cuda_kernel_matches_plain_version(cuda_device, dtype, bs, H, Hkv,
                                           Dh, alias, n_pages):
    case = paged_case(bs, B_lengths=tail_lengths(bs), H=H, Hkv=Hkv, Dh=Dh,
                      L=3, bs=bs, alias=alias, n_pages=n_pages)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tables, lengths, 2)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(q, kp, vp, tables, lengths, 2)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) < TOL_F32
    else:
        assert bf16_excess(out.float().cpu(), ref.float().cpu()) <= 0
    assert float(out[4].abs().max()) == 0.0   # the dead slot


@pytest.mark.cuda
def test_cuda_engine_streams_match_cpu(cuda_device):
    """The serving engine on the card goes through the kernel once per layer
    per decode step, and in f32 (TF32 off) gives the CPU engine's streams."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("smollm-360m").reduced().with_overrides(
        n_heads=6, n_kv_heads=2, head_dim=32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 12)
            for n in rng.integers(3, 30, size=5)]
    streams = []
    for device in ("cpu", cuda_device):
        eng = ServeEngine(cfg, params, capacity=48, max_batch=3,
                          block_size=8, num_blocks=8, device=device)
        rids = [eng.submit(p, b) for p, b in reqs]
        before = paged_attention.launches
        res = eng.run()
        launched = paged_attention.launches - before
        streams.append([res[r] for r in rids])
    assert eng.stats["preemptions"] > 0
    assert launched == cfg.n_layers * eng.stats["decode_steps"] > 0
    assert streams[0] == streams[1]
