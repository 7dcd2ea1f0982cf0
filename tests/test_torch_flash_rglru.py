"""The port's prefill kernel modules vs the JAX package's.

On the CPU the port's plain versions ``attention_ref`` (the oracle of the
CUDA ``flash_attention`` kernel) and ``rglru_ref`` (the oracle of the CUDA
``rglru_scan`` kernel) are held against the JAX oracles in
``repro.kernels.ref`` and against the JAX Pallas kernels run in interpret
mode, on identical numpy inputs: the reference's own sweeps (MHA, GQA and
MQA, Dh 64 and 128, windows 32/64/100, non-causal, f32 and bf16), and the
shapes the Pallas kernels cannot take (S not a multiple of the block, Dh 256
with 10 query heads over one KV head). The wrappers' CPU dispatch and
argument checks are tested here too; the CUDA kernels themselves are held
against the plain versions on the card by ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels import rglru_ref as jax_rglru_ref  # noqa: E402
from repro.kernels import rglru_scan as jax_rglru_scan  # noqa: E402
from repro_torch.kernels import (attention_ref, flash_attention, ops,  # noqa: E402
                                 rglru_ref, rglru_scan)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

# f32: the same full softmax in f32, summed in another order (XLA's dot vs
# oneDNN), a few ulp of O(1) outputs. bf16: both sides widen to f32 and
# round the output once, so an element may differ by one bf16 ulp, 2**-8
# of |out| (|out| < 4 here); the limit is two such ulps at |out| = 4.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -5}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def qkv(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32))


def port_attn(arrays, dtype, **kw):
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return attention_ref(q, k, v, **kw).float().numpy()


def jax_attn(arrays, dtype, **kw):
    q, k, v = (jnp.asarray(a, JNP[dtype]) for a in arrays)
    return np.asarray(jax_attention_ref(q, k, v, **kw).astype(jnp.float32))


def pallas_attn(arrays, dtype, **kw):
    q, k, v = (jnp.asarray(a, JNP[dtype]) for a in arrays)
    return np.asarray(jax_flash_attention(q, k, v, interpret=True, **kw)
                      .astype(jnp.float32))


def err(a, b):
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),      # MHA
    (2, 4, 2, 256, 64, 128, 128),    # GQA 2:1
    (1, 8, 1, 128, 128, 128, 64),    # MQA, Dh=128
])
def test_attention_ref_causal_sweep(dtype, B, H, Hkv, S, D, bq, bk):
    """tests/test_kernels.py:50's sweep: the plain version against the JAX
    oracle and the Pallas kernel in interpret mode."""
    arrays = qkv(0, B, H, Hkv, S, D)
    out = port_attn(arrays, dtype, causal=True)
    assert err(out, jax_attn(arrays, dtype, causal=True)) < TOL[dtype]
    assert err(out, pallas_attn(arrays, dtype, causal=True, block_q=bq,
                                block_k=bk)) < TOL[dtype]


@pytest.mark.parametrize("window", [32, 64, 100])
def test_attention_ref_sliding_window(window):
    arrays = qkv(1, 1, 2, 2, 256, 64)
    out = port_attn(arrays, torch.float32, causal=True, window=window)
    assert err(out, jax_attn(arrays, torch.float32, causal=True,
                             window=window)) < TOL[torch.float32]
    assert err(out, pallas_attn(arrays, torch.float32, causal=True,
                                window=window, block_q=64, block_k=64)) \
        < TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_ref_noncausal(dtype):
    arrays = qkv(2, 1, 2, 2, 128, 64)
    out = port_attn(arrays, dtype, causal=False)
    assert err(out, jax_attn(arrays, dtype, causal=False)) < TOL[dtype]
    assert err(out, pallas_attn(arrays, dtype, causal=False, block_q=64,
                                block_k=64)) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (1, 10, 1, 300, 256, True, 64),   # recurrentgemma's heads, window bites
    (1, 10, 1, 37, 256, True, None),  # S below and not a multiple of a tile
    (2, 15, 5, 100, 64, True, None),  # smollm's heads, odd S
    (1, 4, 2, 77, 32, False, 16),     # window without causality
    (1, 2, 1, 50, 64, True, 1),       # window 1: each row sees itself
])
def test_attention_ref_shapes_pallas_cannot_take(dtype, B, H, Hkv, S, D,
                                                 causal, window):
    """Shapes the CUDA kernel takes and the Pallas kernel asserts away:
    against the JAX oracle."""
    arrays = qkv(3, B, H, Hkv, S, D)
    out = port_attn(arrays, dtype, causal=causal, window=window)
    assert err(out, jax_attn(arrays, dtype, causal=causal, window=window)) \
        < TOL[dtype]


def test_attention_ref_rows_with_nothing_to_attend_are_zero():
    """Non-causal with a window, keys past the queries: a query row whose
    window holds no key gets zeros, in both oracles."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 2, 12, 32), dtype=np.float32)
    k = rng.standard_normal((1, 1, 6, 32), dtype=np.float32)
    v = rng.standard_normal((1, 1, 6, 32), dtype=np.float32)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=False, window=3).numpy()
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=False,
                                       window=3))
    assert np.all(out[:, :, 8:] == 0) and np.all(np.isfinite(out))
    assert err(out, ref) < TOL[torch.float32]


def ar_inputs(seed, B, S, R):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, R))))
    x = rng.standard_normal((B, S, R))
    return a.astype(np.float32), x.astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R,chunk,br", [
    (1, 128, 128, 64, 128),
    (2, 256, 256, 128, 128),
    (1, 512, 384, 256, 128),
])
def test_rglru_ref_sweep(dtype, B, S, R, chunk, br):
    """tests/test_kernels.py:92's sweep. The plain version carries h in the
    inputs' dtype, as the JAX oracle does: in f32 both are the same
    multiply-then-add chain (1e-5 covers XLA contracting it to an FMA); in
    bf16 the limit is the reference's own 5e-2 for a bf16 recurrence. The
    Pallas kernel carries h in f32: the plain version fed the inputs
    widened to f32 and rounded once at the end computes that (f32: 1e-5;
    bf16: one bf16 ulp of |h| <= 8, 2**-5)."""
    a, x = ar_inputs(4, B, S, R)
    ta, tx = torch.from_numpy(a).to(dtype), torch.from_numpy(x).to(dtype)
    ja, jx = jnp.asarray(a, JNP[dtype]), jnp.asarray(x, JNP[dtype])
    out = rglru_ref(ta, tx)
    assert out.dtype == dtype
    ref = np.asarray(jax_rglru_ref(ja, jx).astype(jnp.float32))
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-5
    assert err(out.float().numpy(), ref) < tol
    pallas = np.asarray(jax_rglru_scan(ja, jx, chunk=chunk, block_r=br,
                                       interpret=True).astype(jnp.float32))
    wide = rglru_ref(ta.float(), tx.float()).to(dtype).float().numpy()
    assert err(wide, pallas) < (2 ** -5 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize("S", [1, 17, 131])
def test_rglru_ref_odd_lengths(S):
    """Any S, which the Pallas kernel's chunking cannot take."""
    a, x = ar_inputs(5, 2, S, 40)
    out = rglru_ref(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_rglru_ref(jnp.asarray(a), jnp.asarray(x)))
    assert out.shape == (2, S, 40) and err(out, ref) < 1e-5


def test_wrappers_cpu_dispatch_uses_plain_versions():
    """On CPU tensors the wrappers and the model's ops return the plain
    versions' results and count no launch."""
    arrays = qkv(6, 1, 4, 2, 70, 64)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    a, x = (torch.from_numpy(t) for t in ar_inputs(6, 1, 33, 16))
    before = flash_attention.launches, rglru_scan.launches
    want = attention_ref(q, k, v, causal=True, window=20)
    for fn in (flash_attention, ops.attention):
        assert torch.equal(fn(q, k, v, causal=True, window=20), want)
    for fn in (rglru_scan, ops.rglru):
        assert torch.equal(fn(a, x), rglru_ref(a, x))
    assert (flash_attention.launches, rglru_scan.launches) == before


def test_flash_wrapper_takes_strided_views():
    """The model hands [B, S, H, Dh] tensors viewed as [B, H, S, Dh]: the
    wrapper takes the views as they are."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 40, 6, 32),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 3, 32),
                                             dtype=np.float32))
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          k.transpose(1, 2), causal=True, window=None)
    want = attention_ref(q.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous())
    assert torch.equal(out, want)


def test_wrappers_reject_bad_arguments():
    q = torch.zeros(1, 4, 16, 64)
    k = torch.zeros(1, 2, 16, 64)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :, :, :32], k[:, :, :, :32])
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention(q[:, :3], k, k)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, k.double(), k.double())
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    a = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="shape"):
        rglru_scan(a, a[:, :7])
    with pytest.raises(TypeError, match="dtype"):
        rglru_scan(a, a.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
