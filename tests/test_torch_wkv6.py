"""The port's WKV scan modules vs the JAX package's.

On the CPU the port's plain versions are held against the JAX package on
identical numpy inputs:

* ``wkv6_ref`` (``[BH, S, Dh]``, zero state; the JAX ``wkv6_ref``
  transcribed) against the JAX oracle and the Pallas ``wkv6_scan`` run in
  interpret mode, over the reference's sweeps (``tests/test_wkv_kernel.py``:
  (BH, S, Dh) of (2, 128, 64), (1, 256, 128) and (3, 192, 64), f32 and
  bf16);
* ``wkv6_scan_ref`` (the model's ``[B, S, H, Dh]`` layout, an initial state
  in and the final state out; the JAX model's ``_wkv_scan`` transcribed),
  the plain version of the CUDA ``wkv6_scan`` kernel, against ``_wkv_scan``
  at S 1, 37 and 64 from a nonzero state.

The wrapper's CPU dispatch and argument checks are tested here too; the
CUDA kernel itself is held against ``wkv6_scan_ref`` on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.kernels.wkv6_scan import wkv6_scan as jax_wkv6_scan  # noqa: E402
from repro.models.rwkv6 import _wkv_scan as jax_wkv_scan  # noqa: E402
from repro_torch.kernels import (ops, wkv6_ref, wkv6_scan,  # noqa: E402
                                 wkv6_scan_ref)
from torch_threads import one_intra_op_thread  # noqa: E402,F401

# (BH, S, Dh, Pallas chunk): tests/test_wkv_kernel.py's sweep
SWEEP = [(2, 128, 64, 64), (1, 256, 128, 128), (3, 192, 64, 64)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# Error model. Both sides run the same f32 recurrence; they differ in the
# order of y's Dh-term dot product and in whether the state's multiply-add
# is fused, so each rounding moves an output by at most 2**-24 of one of
# its terms. ``M``, the recurrence run on |inputs| (|r|, |k|, |v|, w, |u|,
# |S_0|), bounds the sum of the terms' magnitudes, element by element. f32:
# the limit is 16 units of roundoff of M, 16 * 2**-24 * M (< 5e-4 here,
# where M < 500; the measured gap is under 4 units), against the
# reference's 1e-3. bf16: both sides round y once to bf16, so an element
# may also differ by one bf16 ulp, at most 2**-7 of |y|; against the
# reference's 0.15.
F32_UNITS = 16 * 2 ** -24
BF16_RTOL = 2 ** -7


def excess(out, ref, mag, dtype):
    """How far ``out`` exceeds its limit around ``ref`` (<= 0 within), for
    the terms' magnitude ``mag``."""
    lim = F32_UNITS * mag
    if dtype == "bfloat16":
        lim = lim + BF16_RTOL * np.abs(ref)
    return float(np.max(np.abs(out - ref) - lim))


def sweep_inputs(BH, S, Dh, seed=0):
    """tests/test_wkv_kernel.py's inputs, drawn with numpy: r/k/v ~ N(0, 1),
    w = 0.98 sigmoid(N(0, 1)), u ~ 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    r, k, v, wn = (rng.standard_normal((BH, S, Dh), dtype=np.float32)
                   for _ in range(4))
    w = (0.98 / (1.0 + np.exp(-wn))).astype(np.float32)
    u = (0.1 * rng.standard_normal((BH, Dh))).astype(np.float32)
    return r, k, v, w, u


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX oracle's and the interpret-mode Pallas kernel's outputs for
    every sweep case, computed once for the module."""
    out = {}
    for BH, S, Dh, chunk in SWEEP:
        arrays = sweep_inputs(BH, S, Dh)
        for name, (_, jdt) in DTYPES.items():
            j = [jnp.asarray(a).astype(jdt) for a in arrays]
            out[BH, S, Dh, name] = (
                np.asarray(jax_wkv6_ref(*j).astype(jnp.float32)),
                np.asarray(jax_wkv6_scan(*j, chunk=chunk, interpret=True)
                           .astype(jnp.float32)))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("BH,S,Dh,chunk", SWEEP)
def test_wkv6_ref_matches_jax_oracle_and_pallas(jax_sweep, dtype, BH, S, Dh,
                                                chunk):
    tdt = DTYPES[dtype][0]
    r, k, v, w, u = (torch.from_numpy(a).to(tdt)
                     for a in sweep_inputs(BH, S, Dh))
    out = wkv6_ref(r, k, v, w, u)
    assert out.dtype == tdt and out.shape == (BH, S, Dh)
    out = out.float().numpy()
    mag = wkv6_ref(*(t.float().abs() for t in (r, k, v, w, u))).numpy()
    ref, pallas = jax_sweep[BH, S, Dh, dtype]
    assert excess(out, ref, mag, dtype) <= 0
    assert excess(out, pallas, mag, dtype) <= 0


def scan_inputs(B, S, H, Dh, seed):
    """Model-layout inputs: r/k/v/w ``[B, S, H, Dh]``, u ``[H, Dh]`` and a
    nonzero initial state ``[B, H, Dh, Dh]``, as numpy f32."""
    rng = np.random.default_rng(seed)
    r, k, v, wn = (rng.standard_normal((B, S, H, Dh), dtype=np.float32)
                   for _ in range(4))
    w = (0.9 / (1.0 + np.exp(-wn))).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, Dh))).astype(np.float32)
    s0 = rng.standard_normal((B, H, Dh, Dh), dtype=np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S", [1, 37, 64])
def test_wkv6_scan_ref_matches_model_scan_with_state(S):
    """y and the final state against the JAX model's ``_wkv_scan`` (the
    oracle for S_T and a nonzero S_0), at a decode step and at odd and even
    prompt lengths."""
    arrays = scan_inputs(2, S, 2, 64, seed=S)
    y, s_t = wkv6_scan_ref(*(torch.from_numpy(a) for a in arrays))
    my, ms = wkv6_scan_ref(*(torch.from_numpy(np.abs(a)) for a in arrays))
    jy, js = jax_wkv_scan(None, *(jnp.asarray(a) for a in arrays))
    assert y.shape == (2, S, 2, 64) and s_t.shape == (2, 2, 64, 64)
    assert s_t.dtype == torch.float32
    assert excess(y.numpy(), np.asarray(jy), my.numpy(), "float32") <= 0
    assert excess(s_t.numpy(), np.asarray(js), ms.numpy(), "float32") <= 0


def test_scan_ref_from_zero_is_wkv6_ref_per_head():
    """The model-layout scan from a zero state is the kernel-layout oracle
    with u tiled over the batch (the reference's time-mix core test)."""
    r, k, v, w, u, _ = (torch.from_numpy(a)
                        for a in scan_inputs(2, 40, 3, 64, seed=1))
    y, _ = wkv6_scan_ref(r, k, v, w, u)

    def flat(t):
        return t.transpose(1, 2).reshape(6, 40, 64)

    y_k = wkv6_ref(flat(r), flat(k), flat(v), flat(w), u.repeat(2, 1))
    assert torch.equal(flat(y), y_k)


def test_wrapper_cpu_dispatch_uses_the_plain_version():
    """CPU tensors go to ``wkv6_scan_ref`` (no launch counted), through the
    model's dispatch point too; r/k/v may be strided views with contiguous
    channels; y comes back in r's dtype and the state in f32."""
    assert ops.wkv6 is wkv6_scan
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in scan_inputs(2, 9, 3, 64, seed=2))
    before = wkv6_scan.launches
    y, s_t = ops.wkv6(r, k, v, w, u, s0)
    ry, rs = wkv6_scan_ref(r, k, v, w, u, s0)
    assert wkv6_scan.launches == before
    assert torch.equal(y, ry) and torch.equal(s_t, rs)
    rv = r.transpose(1, 2).contiguous().transpose(1, 2)    # [B, H, S, Dh]
    assert torch.equal(wkv6_scan(rv, k, v, w, u, s0)[0], y)
    yb, sb = wkv6_scan(r.bfloat16(), k.bfloat16(), v.bfloat16(), w, u)
    assert yb.dtype == torch.bfloat16 and sb.dtype == torch.float32
    assert torch.equal(yb, wkv6_scan_ref(r.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), w, u)[0])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in scan_inputs(1, 4, 2, 64, seed=3))
    with pytest.raises(TypeError, match="float32"):
        wkv6_scan(r, k, v, w.bfloat16(), u)
    with pytest.raises(TypeError, match="one dtype"):
        wkv6_scan(r, k.bfloat16(), v, w, u)
    with pytest.raises(ValueError, match="Dh in"):
        wkv6_scan(*(t[..., :32] for t in (r, k, v, w)), u[:, :32])
    with pytest.raises(ValueError, match="u must be"):
        wkv6_scan(r, k, v, w, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        wkv6_scan(r, k, v, w, u, s0[..., :32])
    with pytest.raises(ValueError, match="channels must be contiguous"):
        wkv6_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, w, u)
    with pytest.raises(ValueError, match="one \\[B, S, H, Dh\\] shape"):
        wkv6_scan(r, k[:, :2], v, w, u)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_scan(r, k, v, w, u, s0.transpose(2, 3))
