"""The port's paged-attention kernel module vs the JAX package's.

On the CPU the port's plain version ``paged_attention_ref`` is held against
the JAX oracle ``repro.kernels.ref.paged_attention_ref`` and against the JAX
Pallas kernel run in interpret mode, on identical numpy inputs: block sizes
4/8/16, GQA ratios 1 and 3, every tail-offset class, dead slots, permuted
and aliased tables, and tables narrowed to the live page count. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import paged_attention_pallas  # noqa: E402
from repro.kernels import paged_attention_ref as jax_paged_attention_ref  # noqa: E402
from repro_torch.kernels import (KERNEL_ORACLES, check_kernel_oracles,  # noqa: E402
                                 paged_attention, paged_attention_ref)
from torch_paged_cases import TOL_F32, bf16_excess, paged_case, tail_lengths  # noqa: E402


def port(case, layer, dtype=torch.float32, fn=paged_attention_ref):
    q, kp, vp, tables, lengths = case
    return fn(torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
              torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
              torch.from_numpy(lengths), layer)


def jax_ref(case, layer, dtype=jnp.float32):
    q, kp, vp, tables, lengths = case
    out = jax_paged_attention_ref(
        jnp.asarray(q, dtype), jnp.asarray(kp, dtype), jnp.asarray(vp, dtype),
        jnp.asarray(tables), jnp.asarray(lengths), layer)
    return np.asarray(out.astype(jnp.float32))


def pallas(case, layer):
    q, kp, vp, tables, lengths = case
    return np.asarray(paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(lengths), layer, interpret=True))


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - b)))


@pytest.mark.parametrize("bs", [4, 8, 16])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (6, 2)])
def test_ref_matches_jax_ref(bs, H, Hkv):
    case = paged_case(bs * 10 + H, B_lengths=tail_lengths(bs), H=H, Hkv=Hkv,
                      Dh=16, L=3, bs=bs)
    for layer in (0, 2):
        out = port(case, layer)
        assert out.dtype == torch.float32
        assert max_err(out, jax_ref(case, layer)) < TOL_F32


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_ref_matches_pallas_interpret(bs):
    """G = 3 (the serving model's ratio) against the Pallas block walk."""
    case = paged_case(bs, B_lengths=tail_lengths(bs), H=6, Hkv=2, Dh=16,
                      L=2, bs=bs)
    out = port(case, 1)
    assert max_err(out, pallas(case, 1)) < TOL_F32


def test_ref_aliased_and_narrowed_tables():
    """Slot 1 aliases slot 0's prefix pages; the table is narrowed to the
    live high-water width (as the engine's pow2 clamp hands it) and also
    given wider, trash-padded: all agree with both JAX versions."""
    bs = 4
    case = paged_case(11, B_lengths=[9, 14, 0, 5], H=6, Hkv=2, Dh=16, L=2,
                      bs=bs, alias=True, n_pages=8)
    q, kp, vp, tables, lengths = case
    assert (tables[1, :2] == tables[0, :2]).all()
    narrow = (q, kp, vp, np.ascontiguousarray(tables[:, :4]), lengths)
    wide_out, narrow_out = port(case, 0), port(narrow, 0)
    assert torch.equal(wide_out, narrow_out)
    assert max_err(narrow_out, jax_ref(narrow, 0)) < TOL_F32
    assert max_err(narrow_out, pallas(narrow, 0)) < TOL_F32


def test_ref_dead_slots_emit_zeros_and_permutation_invariance():
    bs = 8
    case = paged_case(5, B_lengths=[0, 13, 0], H=3, Hkv=1, Dh=8, L=1, bs=bs,
                      extra_blocks=4)
    out = port(case, 0)
    assert float(out[[0, 2]].abs().max()) == 0.0
    assert torch.isfinite(out).all() and float(out[1].abs().max()) > 0
    # the same logical content under another physical layout: equal bits
    q, kp, vp, tables, lengths = case
    nb = kp.shape[0] - 1
    perm = np.random.default_rng(0).permutation(nb)   # block i -> perm[i]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[perm], vp2[perm] = kp[:nb], vp[:nb]
    t2 = np.where(tables < nb, perm[np.minimum(tables, nb - 1)],
                  tables).astype(np.int32)
    assert torch.equal(port((q, kp2, vp2, t2, lengths), 0), out)


def test_ref_bf16_matches_jax_ref():
    bs = 16
    case = paged_case(3, B_lengths=tail_lengths(bs), H=15, Hkv=5, Dh=64,
                      L=2, bs=bs)
    out = port(case, 1, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert bf16_excess(out.float(), jax_ref(case, 1, jnp.bfloat16)) <= 0


def test_wrapper_cpu_dispatch_uses_plain_version():
    """CPU tensors go to the plain version (bitwise), and no kernel launch
    is counted."""
    case = paged_case(7, B_lengths=[5, 0, 12], H=6, Hkv=2, Dh=16, L=2, bs=4)
    before = paged_attention.launches
    out = port(case, 1, fn=paged_attention)
    assert torch.equal(out, port(case, 1))
    assert paged_attention.launches == before


def test_wrapper_rejects_bad_arguments():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in paged_case(
        1, B_lengths=[5, 3], H=4, Hkv=2, Dh=8, L=2, bs=4))
    with pytest.raises(TypeError):
        paged_attention(q.double(), kp.double(), vp.double(), tables,
                        lengths, 0)
    with pytest.raises(TypeError):
        paged_attention(q, kp, vp, tables.long(), lengths, 0)
    with pytest.raises(ValueError, match="shape"):
        paged_attention(q, kp, vp[..., :4].contiguous(), tables, lengths, 0)
    with pytest.raises(ValueError, match="layer"):
        paged_attention(q, kp, vp, tables, lengths, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kp,
                        vp, tables, lengths, 0)
    with pytest.raises(ValueError, match="tables"):
        paged_attention(q, kp, vp, tables[:1], lengths, 0)
    with pytest.raises(ValueError, match="one slot"):
        paged_attention(q[:0], kp, vp, tables[:0], lengths[:0], 0)
    with pytest.raises(ValueError, match="multiple of 8"):
        paged_attention(q[..., :4].contiguous(), kp[..., :4].contiguous(),
                        vp[..., :4].contiguous(), tables, lengths, 0)


def test_kernel_oracles_registry_self_test():
    assert KERNEL_ORACLES["paged_attention"][0] == "paged_attention_ref"
    assert check_kernel_oracles() == []
    broken = {"paged_attention": ("no_such_ref", "tests/no_such_test.py"),
              "ghost_kernel": ("paged_attention_ref",
                               "tests/test_torch_kernels.py")}
    problems = check_kernel_oracles(broken)
    assert any("no_such_ref" in p for p in problems)
    assert any("no_such_test.py" in p for p in problems)
    assert any(p.startswith("ghost_kernel") for p in problems)
    assert check_kernel_oracles({}) == [
        "csrc/paged_attention.cu has no KERNEL_ORACLES entry"]
