"""The port's CUDA paged-attention kernels (decode and the speculative
verify window) vs their plain PyTorch versions, on the card, and the
serving engine on the card vs the CPU. JAX-free, so it runs on a GPU host
without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_kernels_cuda.py

Every test skips without a card (the kernels have no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (paged_attention, paged_attention_multi,  # noqa: E402
                                 paged_attention_multi_ref,
                                 paged_attention_ref)
from torch_paged_cases import (TOL_F32, bf16_excess, multi_case,  # noqa: E402
                               paged_case, tail_lengths, window_lengths)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,bs,H,Hkv,Dh,alias,cover", [
    (4, 16, 15, 5, 64, True, None),  # smollm-360m's heads at k = 3
    (4, 16, 15, 5, 64, False, 3),    # last rows past the table's coverage
    (5, 4, 4, 2, 64, False, None),   # the window spans a block
    (2, 8, 6, 2, 128, False, None),
    (8, 8, 16, 2, 128, False, None), # 64 rows: >48 KB of shared memory
])
def test_cuda_multi_kernel_matches_plain_version(cuda_device, dtype, Q, bs,
                                                 H, Hkv, Dh, alias, cover):
    case = multi_case(Q * bs + H, lengths=window_lengths(Q, bs) + [2], Q=Q,
                      H=H, Hkv=Hkv, Dh=Dh, L=3, bs=bs, alias=alias,
                      cover=cover)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, kp, vp, tables, lengths, 2)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    ref = paged_attention_multi_ref(q, kp, vp, tables, lengths, 2)
    assert out.dtype == dtype and out.shape == q.shape
    if dtype == torch.float32:
        assert float((out - ref).abs().max()) < TOL_F32
    else:
        assert bf16_excess(out.float().cpu(), ref.float().cpu()) <= 0
    assert float(out[3].abs().max()) == 0.0   # the dead slot
    if Q > 2:   # the slot of length 2: rows with nothing to attend
        assert float(out[5, :Q - 2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_multi_kernel_window_of_one_is_decode(cuda_device, dtype):
    """Q = 1 launches the same template as the decode kernel: equal bits."""
    case = paged_case(2, B_lengths=tail_lengths(16), H=15, Hkv=5, Dh=64,
                      L=2, bs=16, alias=True)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    multi = paged_attention_multi(q[:, None].contiguous(), kp, vp, tables,
                                  lengths, 1)
    assert torch.equal(multi[:, 0], paged_attention(q, kp, vp, tables,
                                                    lengths, 1))


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


@pytest.mark.cuda
def test_cuda_spec_engine_streams_match_cpu(cuda_device):
    """The speculative engine on the card verifies through the window
    kernel once per layer per round, never through the decode kernel, and
    in f32 (TF32 off) gives the CPU engine's streams and counts."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, SpecConfig
    from repro_torch.weights import truncate_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("smollm-360m").reduced().with_overrides(
        n_heads=6, n_kv_heads=2, head_dim=32, n_layers=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def damp(tree):   # layers 1.. scaled by 0.3: the draft mostly agrees
        for leaf in tree.values():
            if isinstance(leaf, dict):
                damp(leaf)
            else:
                leaf[1:] *= 0.3

    damp(params["layers"])
    spec = SpecConfig(cfg.with_overrides(n_layers=1),
                      truncate_params(params, 1), k=3)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 12)
            for n in rng.integers(3, 30, size=5)]
    runs = []
    for device in ("cpu", cuda_device):
        eng = ServeEngine(cfg, params, capacity=48, max_batch=3,
                          block_size=8, num_blocks=9, speculate=spec,
                          device=device)
        rids = [eng.submit(p, b) for p, b in reqs]
        before = (paged_attention.launches, paged_attention_multi.launches)
        res = eng.run()
        launched = (paged_attention.launches - before[0],
                    paged_attention_multi.launches - before[1])
        st = eng.stats
        runs.append(([res[r] for r in rids],
                     {k: st[k] for k in ("spec_proposed", "spec_accepted",
                                         "draft_prefills", "preemptions")}))
    rounds = st["decode_dispatches"] * spec.rounds_for(eng.decode_chunk)
    assert launched == (0, cfg.n_layers * rounds) and rounds > 0
    assert st["preemptions"] > 0
    assert 0 < st["spec_accepted"] < st["spec_proposed"]
    assert runs[0] == runs[1]
