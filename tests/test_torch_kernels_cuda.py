"""The port's CUDA kernels — paged attention (decode and the speculative
verify window), flash attention, the RG-LRU scan and the WKV scan — vs
their plain PyTorch versions, on the card, and the serving engine on the
card vs the CPU. JAX-free, so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_kernels_cuda.py

Every test skips without a card (the kernels have no CPU mode).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (attention_ref, flash_attention,  # noqa: E402
                                 paged_attention, paged_attention_multi,
                                 paged_attention_multi_ref,
                                 paged_attention_ref, rglru_ref, rglru_scan,
                                 wkv6_scan, wkv6_scan_ref)
from torch_paged_cases import (BF16_ATOL, TOL_F32, bf16_excess,  # noqa: E402
                               multi_case, paged_case, tail_lengths,
                               window_lengths)


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
        eng = ServeEngine(cfg, params, mode="paged", capacity=48,
                          max_batch=3, block_size=8, num_blocks=8,
                          device=device)
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
        eng = ServeEngine(cfg, params, mode="paged", capacity=48,
                          max_batch=3, block_size=8, num_blocks=9,
                          speculate=spec,
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


def flash_inputs(device, dtype, B, H, Hkv, Sq, Skv, Dh, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, H, Sq, Dh), generator=g)
    k = torch.randn((B, Hkv, Skv, Dh), generator=g)
    v = torch.randn((B, Hkv, Skv, Dh), generator=g)
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


def check_close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    if out.dtype == torch.float32:
        assert float((out - ref).abs().max()) < TOL_F32
    else:
        assert bf16_excess(out.float().cpu(), ref.float().cpu()) <= 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,Dh,causal,window", [
    (1, 2, 2, 128, 64, True, None),     # MHA
    (2, 4, 2, 256, 64, True, None),     # GQA 2:1
    (1, 8, 1, 128, 128, True, None),    # MQA, Dh 128
    (1, 2, 2, 256, 64, True, 32),       # windows (the reference's sweep)
    (1, 2, 2, 256, 64, True, 100),
    (1, 2, 2, 128, 64, False, None),    # non-causal
    (1, 15, 5, 300, 64, True, None),    # smollm's prefill, tail tile
    (1, 10, 1, 300, 256, True, 64),     # recurrentgemma's heads, window
    (1, 10, 1, 37, 256, True, None),    # S below one tile
    (2, 4, 2, 77, 32, False, 16),       # window without causality
    (1, 2, 1, 50, 128, True, 1),        # window 1: each row sees itself
    (1, 6, 2, 200, 32, True, None),     # Dh 32: the scale is not 2**-k
    (2, 4, 1, 160, 128, True, 48),      # Dh 128, window: the same
])
def test_cuda_flash_matches_plain_version(cuda_device, dtype, B, H, Hkv, S,
                                          Dh, causal, window):
    q, k, v = flash_inputs(cuda_device, dtype, B, H, Hkv, S, S, Dh)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    check_close(out, attention_ref(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_dead_rows_and_strided_views(cuda_device, dtype):
    """Rows whose window holds no key (non-causal, fewer keys than queries)
    give zeros, and [B, S, H, Dh] tensors viewed as [B, H, S, Dh] are read
    through their strides, the output written in q's layout."""
    q, k, v = flash_inputs(cuda_device, dtype, 1, 4, 2, 140, 70, 64, seed=1)
    out = flash_attention(q, k, v, causal=False, window=8)
    torch.cuda.synchronize()
    check_close(out, attention_ref(q, k, v, causal=False, window=8))
    assert float(out[:, :, 77:].abs().max()) == 0.0
    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in
                  flash_inputs(cuda_device, dtype, 2, 10, 1, 200, 200, 256))
    out = flash_attention(qs.transpose(1, 2), ks.transpose(1, 2),
                          vs.transpose(1, 2), causal=True, window=64)
    assert out.stride() == qs.transpose(1, 2).stride()
    check_close(out, attention_ref(qs.transpose(1, 2).contiguous(),
                                   ks.transpose(1, 2).contiguous(),
                                   vs.transpose(1, 2).contiguous(),
                                   causal=True, window=64))


@pytest.mark.cuda
def test_cuda_flash_full_prefill_shape(cuda_device):
    """recurrentgemma-2b's prefill as the model hands it over: 10 query
    heads over one KV head, Dh 256, a 2 300-token prompt, window 2 048,
    [B, S, H, Dh] tensors viewed as [B, H, S, Dh]; bf16 on the tensor-core
    body and f32 on the CUDA-core one."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in
                   flash_inputs(cuda_device, dtype, 1, 10, 1, 2300, 2300,
                                256, seed=3))
        out = flash_attention(q, k, v, causal=True, window=2048)
        torch.cuda.synchronize()
        check_close(out, attention_ref(q, k, v, causal=True, window=2048))


def cancelling_case(H=4, S=96, Dh=64, seed=4):
    """q, k, v (bf16, [1, H, S, Dh]) whose causal rows 1-3 nearly cancel:
    v at key r (r = 1, 2, 3) is solved, head by head, so that row r's
    attention output is about 1e-3 of |v| before v is rounded to bf16, while
    sum_j p_j |v_j| stays O(1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a).bfloat16()   # noqa: E731
    q = bf(0.3 * rng.standard_normal((1, H, S, Dh), np.float32))
    k = bf(rng.standard_normal((1, H, S, Dh), np.float32))
    v = rng.standard_normal((1, H, S, Dh))
    s = np.einsum("bhqd,bhkd->bhqk", q.double().numpy(),
                  k.double().numpy()) * Dh ** -0.5
    for r in (1, 2, 3):
        p = np.exp(s[0, :, r, :r + 1] - s[0, :, r, :r + 1].max(-1,
                                                                  keepdims=True))
        p /= p.sum(-1, keepdims=True)                       # [H, r + 1]
        rest = np.einsum("hj,hjd->hd", p[:, :r], v[0, :, :r])
        v[0, :, r] = (1e-3 * rng.standard_normal((H, Dh)) - rest) \
            / p[:, r:r + 1]
    return q, k, bf(v.astype(np.float32))


@pytest.mark.cuda
def test_cuda_flash_bf16_holds_cancelling_rows(cuda_device):
    """The bf16 body's PV keeps P to ~2**-17 (P split into two bf16 terms):
    on rows whose values cancel (|plain| << sum p |v|) it holds the
    unchanged limit, which a PV with P rounded once to bf16 (one-pass, as
    the library does) exceeds on the same inputs."""
    q, k, v = (t.to(cuda_device) for t in cancelling_case())
    out = flash_attention(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    check_close(out, ref)
    spread = attention_ref(q, k, v.abs(), causal=True).float()
    rows = slice(1, 4)
    assert float((ref[:, :, rows].float().abs()
                  / spread[:, :, rows]).median()) < 0.05
    # one-pass: unnormalised P = exp(s - max) rounded to bf16 before PV
    Dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * Dh ** -0.5
    S = s.shape[-1]
    s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                 device=s.device).triu(1), float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    one_pass = (torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                             v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    assert bf16_excess(one_pass[:, :, rows].float().cpu(),
                       ref[:, :, rows].float().cpu()) > 0
    assert bf16_excess(out[:, :, rows].float().cpu(),
                       ref[:, :, rows].float().cpu()) <= 0


# The decode kernel splits a slot's positions over a cluster of
# min(8, ceil(n_pages * block_size / 64)) blocks, ceil(length / C) each: 32
# pages of 16 give C = 8. Lengths: a dead slot (no rank sees anything), one
# position (one rank), 5 (ranks 5-7 empty), 49 (7 ranks of 7, the last
# empty), 64 (one rank's coverage), 65, 300, and the full coverage 512;
# slot 1 shares slot 0's 4 pages.
CLUSTER_LENGTHS = [64, 300, 0, 1, 5, 49, 65, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,Dh", [(15, 5, 64), (8, 8, 128), (6, 2, 8)])
def test_cuda_decode_cluster_shares(cuda_device, dtype, H, Hkv, Dh):
    case = paged_case(11, B_lengths=CLUSTER_LENGTHS, H=H, Hkv=Hkv, Dh=Dh,
                      L=2, bs=16, n_pages=32, alias=True)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention.launches
    out = paged_attention(q, kp, vp, tables, lengths, 1)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    check_close(out, paged_attention_ref(q, kp, vp, tables, lengths, 1))
    assert float(out[2].abs().max()) == 0.0   # the dead slot
    # one position: the output is that position's V row, to the rounding
    pos0 = vp[tables[3, 0].long(), 0, 1].float()           # [Hkv, Dh]
    want = pos0.repeat_interleave(H // Hkv, dim=0)
    assert float((out[3].float() - want).abs().max()) <= \
        float(BF16_ATOL + 2 ** -7 * want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_long_table_read_in_place(cuda_device, dtype):
    """A block table wider than the 1 024 entries the kernel stages in
    shared memory (pages of one position) is read in place."""
    case = paged_case(13, B_lengths=[1100, 7, 0, 1030], H=6, Hkv=2, Dh=64,
                      L=1, bs=1, n_pages=1100)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    out = paged_attention(q, kp, vp, tables, lengths, 0)
    torch.cuda.synchronize()
    check_close(out, paged_attention_ref(q, kp, vp, tables, lengths, 0))
    assert float(out[2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,H,Hkv,Dh", [
    (4, 15, 5, 64),     # k = 3 at smollm-360m's heads: 12 rows, G 3
    (8, 16, 2, 128),    # the 64-row limit
])
def test_cuda_multi_kernel_cluster_shares(cuda_device, dtype, Q, H, Hkv,
                                          Dh):
    """The verify window on the decode kernel's cluster body, C = 8: rows
    whose limits fall in other ranks' shares, or at or below 0."""
    lengths = list(CLUSTER_LENGTHS)
    lengths[3] = Q - 2          # rows 0 and 1 see nothing
    case = multi_case(12, lengths=lengths, Q=Q, H=H, Hkv=Hkv, Dh=Dh, L=2,
                      bs=16, n_pages=32, alias=True)
    q, kp, vp, tables, lengths = (torch.from_numpy(a).to(cuda_device)
                                  for a in case)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = paged_attention_multi.launches
    out = paged_attention_multi(q, kp, vp, tables, lengths, 0)
    torch.cuda.synchronize()
    assert paged_attention_multi.launches == before + 1
    check_close(out, paged_attention_multi_ref(q, kp, vp, tables, lengths,
                                               0))
    assert float(out[2].abs().max()) == 0.0   # the dead slot
    assert float(out[3, :2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,R", [(1, 128, 128), (2, 256, 256),
                                   (1, 512, 384), (1, 2300, 2560),
                                   (3, 37, 100),
                                   (2, 5, 2568),     # a masked tail tile
                                   (1, 1001, 2560)])  # S past a ring stage
def test_cuda_rglru_scan_matches_plain_version(cuda_device, B, S, R):
    """f32: the kernel and the plain version compute the same rounded
    multiply-then-add chain, bit for bit. bf16: the kernel carries h in f32,
    so it equals the plain version run on the inputs widened to f32 and
    rounded once, bit for bit; against the plain version's bf16 carry the
    limit is the JAX package's own 5e-2 for a bf16 recurrence
    (tests/test_kernels.py:104)."""
    g = torch.Generator(device="cpu").manual_seed(S)
    a = torch.sigmoid(torch.randn((B, S, R), generator=g)).to(cuda_device)
    x = torch.randn((B, S, R), generator=g).to(cuda_device)
    before = rglru_scan.launches
    assert torch.equal(rglru_scan(a, x), rglru_ref(a, x))
    ab, xb = a.bfloat16(), x.bfloat16()
    out = rglru_scan(ab, xb)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 2
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, rglru_ref(ab.float(), xb.float()).bfloat16())
    assert float((out.float() - rglru_ref(ab, xb).float()).abs().max()) \
        < 5e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rglru_scan_reads_unaligned_rows(cuda_device, dtype):
    """Inputs and output whose rows do not start on 16 bytes: a and x as
    contiguous views one element into their storage, and R 101, whose rows
    drift across 16-byte boundaries. The kernel stages such rows through
    the 16-byte units around them; the result is the plain version's, bit
    for bit (bf16: against the inputs widened to f32)."""
    B, S, R = 2, 300, 101
    g = torch.Generator(device="cpu").manual_seed(R)
    a = torch.sigmoid(torch.randn((B, S, R), generator=g))
    x = torch.randn((B, S, R), generator=g)
    a, x = (torch.cat([t.new_zeros(1), t.flatten()]).to(cuda_device, dtype)
            [1:].view(B, S, R) for t in (a, x))
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    out = rglru_scan(a, x)
    torch.cuda.synchronize()
    assert torch.equal(out, rglru_ref(a.float(), x.float()).to(dtype))


@pytest.mark.cuda
def test_cuda_continuous_hybrid_streams_match_cpu(cuda_device):
    """Continuous serving of the hybrid family on the card runs the flash
    kernel once per attention layer and the scan once per recurrent layer
    per prefill, and in f32 (TF32 off) gives the CPU engine's streams."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("recurrentgemma-2b").reduced().with_overrides(n_layers=5)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 8)
            for n in rng.integers(3, 90, size=5)]
    streams = []
    for device in ("cpu", cuda_device):
        eng = ServeEngine(cfg, params, mode="continuous", capacity=96,
                          max_batch=2, decode_chunk=3, device=device)
        rids = [eng.submit(p, b) for p, b in reqs]
        before = flash_attention.launches, rglru_scan.launches
        res = eng.run()
        launched = (flash_attention.launches - before[0],
                    rglru_scan.launches - before[1])
        streams.append([res[r] for r in rids])
    # 5 layers: one (rec, rec, attn) block and two trailing rec layers
    assert launched == (1 * len(reqs), 4 * len(reqs))
    assert streams[0] == streams[1]


# WKV scan, kernel vs plain version. Both carry the state in f32 and round
# its update the same way (k v, u (k v), each sum, w S), so the final states
# agree bit for bit. y is each column's Dh-term dot product, summed in
# another order: each rounding moves it by at most 2**-24 of one term, and
# the recurrence run on |inputs| bounds the terms' summed magnitude M, so
# the limit is 16 units of roundoff of M; in bf16 y is also rounded once,
# which may move it by one bf16 ulp, 2**-7 of |y|.
WKV_UNITS = 16 * 2 ** -24
WKV_BF16_RTOL = 2 ** -7


def wkv_inputs(device, B, S, H, Dh, *, seed, dtype=torch.float32,
               state=True):
    """r/k/v ``[B, S, H, Dh]`` in ``dtype``, the decay w (0.98 sigmoid of a
    normal draw, as the JAX package's kernel test draws it) in f32, u
    ``[H, Dh]`` and an initial state (or None), on ``device``."""
    g = torch.Generator().manual_seed(seed)
    r, k, v, wn = (torch.randn((B, S, H, Dh), generator=g) for _ in range(4))
    u = 0.1 * torch.randn((H, Dh), generator=g)
    s0 = torch.randn((B, H, Dh, Dh), generator=g) if state else None
    return (*(t.to(device, dtype) for t in (r, k, v)),
            (0.98 * torch.sigmoid(wn)).to(device), u.to(device),
            None if s0 is None else s0.to(device))


def check_wkv(args):
    """Run the kernel and the plain version on ``args``; the final states
    must be equal and y within the limit above. Returns the kernel's y."""
    torch.backends.cuda.matmul.allow_tf32 = False
    before = wkv6_scan.launches
    y, s_t = wkv6_scan(*args)
    torch.cuda.synchronize()
    assert wkv6_scan.launches == before + 1
    ry, rs = wkv6_scan_ref(*args)
    r, k, v, w, u, s0 = args
    my, _ = wkv6_scan_ref(r.float().abs(), k.float().abs(), v.float().abs(),
                          w, u.abs(), None if s0 is None else s0.abs())
    assert y.dtype == r.dtype and y.shape == r.shape
    assert s_t.dtype == torch.float32 and torch.equal(s_t, rs)
    lim = WKV_UNITS * my
    if r.dtype == torch.bfloat16:
        lim = lim + WKV_BF16_RTOL * ry.float().abs()
    assert float(((y.float() - ry.float()).abs() - lim).max()) <= 0
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True], ids=["zero", "S0"])
@pytest.mark.parametrize("B,S,H,Dh", [
    (1, 128, 2, 64), (1, 256, 1, 128), (1, 192, 3, 64),  # the JAX sweep
    (2, 37, 4, 128),                                     # odd S
    (4, 1, 32, 64),                                      # a decode step
    (1, 2300, 32, 64),                                   # full-width prefill
    (3, 1000, 5, 64),      # S past whole chunks, an odd B H
    (1, 600, 16, 128),     # Dh 128 on most of the card
])
def test_cuda_wkv6_scan_matches_plain_version(cuda_device, dtype, state, B,
                                              S, H, Dh):
    check_wkv(wkv_inputs(cuda_device, B, S, H, Dh, seed=S + Dh,
                         dtype=dtype, state=state))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wkv6_scan_reads_strided_views(cuda_device, dtype):
    """r/k/v/w read through their strides: ``[B, H, S, Dh]`` tensors viewed
    as ``[B, S, H, Dh]``, and channel slices of a wider last axis (a fused
    projection); the result equals the contiguous call's, bit for bit."""
    r, k, v, w, u, s0 = wkv_inputs(cuda_device, 2, 29, 3, 64, seed=5,
                                   dtype=dtype)
    rv = r.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.cat([k, k], dim=-1)
    kv_ = wide[..., 64:]                  # head stride 128, channels dense
    wv = w.transpose(1, 2).contiguous().transpose(1, 2)
    assert rv.stride() != r.stride() and kv_.stride() != k.stride()
    y = check_wkv((rv, kv_, v, wv, u, s0))
    y0, _ = wkv6_scan(r, k, v, w, u, s0)
    assert torch.equal(y, y0)


@pytest.mark.cuda
def test_cuda_wkv6_scan_chains_states(cuda_device):
    """A prompt scanned whole equals it scanned in two parts, the second
    from the first's final state, and then one decode step at a time: the
    prefill-then-decode path, bit for bit."""
    r, k, v, w, u, s0 = wkv_inputs(cuda_device, 2, 40, 4, 64, seed=6)
    y, s_t = wkv6_scan(r, k, v, w, u, s0)
    ya, sa = wkv6_scan(*(t[:, :33] for t in (r, k, v, w)), u, s0)
    parts, st = [ya], sa
    for t in range(33, 40):
        yt, st = wkv6_scan(*(x[:, t:t + 1] for x in (r, k, v, w)), u, st)
        parts.append(yt)
    assert torch.equal(torch.cat(parts, dim=1), y) and torch.equal(st, s_t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wkv6_scan_chains_full_width(cuda_device, dtype):
    """At rwkv6-1.6b's prefill shape, a 2 300-step scan equals 2 299 steps
    and then one decode step from their final state, y and the final state
    bit for bit."""
    r, k, v, w, u, _ = wkv_inputs(cuda_device, 1, 2300, 32, 64, seed=7,
                                  dtype=dtype, state=False)
    y, s_t = wkv6_scan(r, k, v, w, u)
    ya, sa = wkv6_scan(*(t[:, :2299] for t in (r, k, v, w)), u)
    yb, sb = wkv6_scan(*(t[:, 2299:] for t in (r, k, v, w)), u, sa)
    assert torch.equal(torch.cat([ya, yb], dim=1), y)
    assert torch.equal(sb, s_t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wkv6_scan_reads_unaligned_rows(cuda_device, dtype):
    """r/k/v/w whose rows do not start on 16 bytes: channel slices one
    element into a wider last axis, and v with an odd sequence stride; and
    s0 a contiguous view one float into its storage. The kernel stages such
    rows through the 16-byte units around them and reads such a state a
    float at a time; the result equals the contiguous call's, bit for
    bit."""
    r, k, v, w, u, s0 = wkv_inputs(cuda_device, 2, 45, 3, 64, seed=8,
                                   dtype=dtype)

    def shifted(t):   # t's values, each row one element into a wider row
        wide = torch.zeros(t.shape[:-1] + (t.shape[-1] + 3,),
                           dtype=t.dtype, device=t.device)
        wide[..., 1:-2] = t
        return wide[..., 1:-2]

    vs = torch.zeros((2, 45, 3 * 64 + 1), dtype=dtype, device=cuda_device)
    vs[..., :-1] = v.flatten(2)
    views = (shifted(r), shifted(k), vs[..., :-1].view(2, 45, 3, 64),
             shifted(w))
    assert all(t.data_ptr() % 16 != 0 or t.stride(1) * t.element_size() % 16
               for t in views)
    s0u = torch.cat([s0.new_zeros(1), s0.flatten()])[1:].view_as(s0)
    assert s0u.is_contiguous() and s0u.data_ptr() % 16 != 0
    y = check_wkv((*views, u, s0u))
    y0, _ = wkv6_scan(r, k, v, w, u, s0)
    assert torch.equal(y, y0)


@pytest.mark.cuda
def test_cuda_continuous_rwkv6_streams_match_cpu(cuda_device):
    """Continuous serving of the ssm family on the card runs the WKV kernel
    once per layer per prefill and per decode step, and in f32 (TF32 off)
    gives the CPU engine's streams."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get("rwkv6-1.6b").reduced().with_overrides(n_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(n)), 8)
            for n in rng.integers(3, 90, size=5)]
    streams = []
    for device in ("cpu", cuda_device):
        eng = ServeEngine(cfg, params, capacity=96, max_batch=2,
                          decode_chunk=3, device=device)
        rids = [eng.submit(p, b) for p, b in reqs]
        before = wkv6_scan.launches
        res = eng.run()
        launched = wkv6_scan.launches - before
        streams.append([res[r] for r in rids])
    st = eng.stats
    assert launched == cfg.n_layers * (st["prefills"] + st["decode_steps"])
    assert streams[0] == streams[1]
