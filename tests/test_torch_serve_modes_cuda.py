"""The shapes the dense configs of the port's eighth slice hand the ported
kernels, and the serving modes that slice added, on the card. JAX-free, so
it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_serve_modes_cuda.py

Paged decode and the verify window at head dim 128 with 8 query heads per
KV head (qwen2.5-3b), 4 (granite-8b) and MHA at 36 heads of 64
(minicpm-2b); flash attention at batch 4 (the cohort drain's left-padded
prefill) with Dh 128 and 8 query heads per KV head, causal and windowed;
each against its plain version. Then a 4-layer qwen-shaped model (QKV
bias, 16 heads over 2 of 128, f32 with TF32 off) served on the card:
``kv_impl="kernel"`` against ``"reference"``, the cohort drain and the
sliding-window variant against the CPU. Every test skips without a card.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import (attention_ref, flash_attention,  # noqa: E402
                                 paged_attention, paged_attention_multi,
                                 paged_attention_multi_ref,
                                 paged_attention_ref)
from torch_paged_cases import (TOL_F32, bf16_excess, multi_case,  # noqa: E402
                               paged_case, tail_lengths, window_lengths)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def check(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    if out.dtype == torch.float32:
        assert float((out - ref).abs().max()) < TOL_F32
    else:
        assert bf16_excess(out.float().cpu(), ref.float().cpu()) <= 0


# (H, Hkv, Dh): qwen2.5-3b, granite-8b, minicpm-2b
HEADS = [(16, 2, 128), (32, 8, 128), (36, 36, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,Dh", HEADS)
def test_cuda_decode_at_the_new_heads(cuda_device, dtype, H, Hkv, Dh):
    case = paged_case(H + Dh, B_lengths=tail_lengths(16), H=H, Hkv=Hkv,
                      Dh=Dh, L=3, bs=16, alias=True)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tables, lengths, 2)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    check(out, paged_attention_ref(q, kp, vp, tables, lengths, 2))
    assert float(out[4].abs().max()) == 0.0   # the dead slot


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,H,Hkv,Dh", [(4, 16, 2, 128), (8, 16, 2, 128),
                                        (4, 32, 8, 128), (4, 36, 36, 64)])
def test_cuda_verify_at_the_new_heads(cuda_device, dtype, Q, H, Hkv, Dh):
    """k 3 on qwen's heads is 32 rows of a thread block, k 7 the kernel's
    64-row limit."""
    case = multi_case(Q + H, lengths=window_lengths(Q, 16) + [2], Q=Q, H=H,
                      Hkv=Hkv, Dh=Dh, L=3, bs=16)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, kp, vp, tables, lengths, 2)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    check(out, paged_attention_multi_ref(q, kp, vp, tables, lengths, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,window", [(300, None), (300, 128), (77, None)])
def test_cuda_flash_batch_of_four_at_dh_128(cuda_device, dtype, S, window):
    """The cohort prefill's batch: q/k/v as the model hands them over,
    ``[B, S, heads, Dh]`` viewed as ``[B, heads, S, Dh]``, so the batch
    stride is S x heads x Dh."""
    g = torch.Generator().manual_seed(S)

    def view(heads):
        return torch.randn((4, S, heads, 128), generator=g).to(
            cuda_device, dtype).transpose(1, 2)

    q, k, v = view(16), view(2), view(2)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.stride() == q.stride()
    check(out, attention_ref(q, k, v, causal=True, window=window))


def qwen_model(**overrides):
    from repro_torch.configs import get
    from repro_torch.models import init_params

    cfg = get("qwen2.5-3b").reduced().with_overrides(
        n_layers=4, n_heads=16, n_kv_heads=2, head_dim=128, **overrides)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    for name in ("wq", "wk", "wv"):
        b = params["layers"]["attn"][name]["b"]
        b.copy_(0.05 * torch.randn(b.shape, generator=g))
    return cfg, params


def requests(vocab, n=5, budget=9):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(s)), budget)
            for s in rng.integers(3, 40, size=n)]


def serve(cfg, params, device, reqs, **kw):
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(cfg, params, device=device, **kw)
    rids = [eng.submit(p, b) for p, b in reqs]
    before = {f.__name__: f.launches for f in (paged_attention,
                                                 flash_attention)}
    res = eng.run()
    launched = {f.__name__: f.launches - before[f.__name__]
                for f in (paged_attention, flash_attention)}
    return [res[r] for r in rids], eng.stats, launched


@pytest.mark.cuda
def test_cuda_kernel_and_reference_read_paths_agree(cuda_device):
    """On a pool that forces preemption, ``kv_impl="kernel"`` launches the
    decode kernel once per layer per step and ``"reference"`` never; both
    give the CPU's streams."""
    cfg, params = qwen_model()
    kw = dict(mode="paged", capacity=64, max_batch=3, block_size=8,
              num_blocks=12, decode_chunk=4)
    reqs = requests(cfg.vocab)
    cpu, _, _ = serve(cfg, params, "cpu", reqs, kv_impl="reference", **kw)
    ker, st, n = serve(cfg, params, cuda_device, reqs, kv_impl="kernel", **kw)
    assert st["preemptions"] > 0
    assert n["paged_attention"] == cfg.n_layers * st["decode_steps"]
    ref, st, n = serve(cfg, params, cuda_device, reqs, kv_impl="reference",
                       prefill_bucket=True, **kw)
    assert n["paged_attention"] == 0
    assert n["flash_attention"] == cfg.n_layers * st["prefills"]
    assert ker == ref == cpu


@pytest.mark.cuda
def test_cuda_cohort_drain_matches_cpu(cuda_device):
    """Cohorts of 4 left-padded prompts: one batch-4 flash launch per layer
    per cohort prefill, no paged kernel, the CPU's streams."""
    cfg, params = qwen_model()
    reqs = requests(cfg.vocab, n=6)
    kw = dict(mode="cohort", capacity=64, max_batch=4)
    cpu, _, _ = serve(cfg, params, "cpu", reqs, **kw)
    out, st, n = serve(cfg, params, cuda_device, reqs, **kw)
    assert st["prefills"] == 2
    assert n == {"paged_attention": 0,
                 "flash_attention": cfg.n_layers * st["prefills"]}
    assert out == cpu


@pytest.mark.cuda
def test_cuda_sliding_window_variant_matches_cpu(cuda_device):
    """The SWA variant (window 16) in continuous mode at capacity 16, with
    prompts past the window: the flash kernel runs with the window and the
    decode ring wraps."""
    cfg, params = qwen_model(window=16)
    reqs = requests(cfg.vocab, n=4, budget=12)
    kw = dict(mode="continuous", capacity=16, max_batch=2, decode_chunk=4)
    cpu, _, _ = serve(cfg, params, "cpu", reqs, **kw)
    out, st, n = serve(cfg, params, cuda_device, reqs, **kw)
    assert n["flash_attention"] == cfg.n_layers * st["prefills"]
    assert out == cpu
