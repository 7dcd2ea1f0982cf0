"""The port's paged-attention kernel modules vs the JAX package's.

On the CPU the port's plain versions ``paged_attention_ref`` (decode, one
token per slot) and ``paged_attention_multi_ref`` (the speculative verify
window of Q tokens) are held against the JAX oracles in
``repro.kernels.ref`` and against the JAX Pallas kernels run in interpret
mode, on identical numpy inputs: block sizes 4/8/16, GQA ratios 1 to 3,
every tail-offset class, windows of 1, 4 and 5 (5 spans a block of 4),
dead slots, permuted and aliased tables, and tables narrowed to the live
page count. The CUDA kernels themselves are held against the plain
versions on the card by ``tests/test_torch_kernels_cuda.py`` and by
``chip_smoke.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro.kernels import paged_attention_multi_ref as jax_multi_ref  # noqa: E402
from repro.kernels import paged_attention_pallas  # noqa: E402
from repro.kernels import paged_attention_ref as jax_paged_attention_ref  # noqa: E402
from repro_torch.kernels import (KERNEL_ORACLES, check_kernel_oracles,  # noqa: E402
                                 paged_attention, paged_attention_multi,
                                 paged_attention_multi_ref,
                                 paged_attention_ref)
from torch_paged_cases import (TOL_F32, bf16_excess, multi_case,  # noqa: E402
                               paged_case, tail_lengths, window_lengths)
from torch_threads import one_intra_op_thread  # noqa: E402,F401


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


# ---------------------------------------------------------------------------
# the verify window: paged_attention_multi
# ---------------------------------------------------------------------------

def jax_multi(case, layer, dtype=jnp.float32, pallas=False):
    q, kp, vp, tables, lengths = (jnp.asarray(a) for a in case)
    q, kp, vp = q.astype(dtype), kp.astype(dtype), vp.astype(dtype)
    if pallas:
        out = ops.paged_attention_multi(q, kp, vp, tables, lengths, layer,
                                        force_pallas=True, interpret=True)
    else:
        out = jax_multi_ref(q, kp, vp, tables, lengths, layer)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("Q", [1, 4, 5])          # 5 spans a block of 4
@pytest.mark.parametrize("H,Hkv", [(2, 2), (4, 2), (6, 2)])
def test_multi_ref_matches_jax_ref_and_pallas(Q, H, Hkv):
    """Every tail-offset class of the window's end, a dead slot, and the
    same inputs through the JAX oracle and the Pallas kernel (interpret)."""
    bs = 4
    case = multi_case(10 * Q + H, lengths=window_lengths(Q, bs), Q=Q, H=H,
                      Hkv=Hkv, Dh=16, L=3, bs=bs)
    for layer in (0, 2):
        out = port(case, layer, fn=paged_attention_multi_ref)
        assert out.dtype == torch.float32 and out.shape == (5, Q, H, 16)
        assert max_err(out, jax_multi(case, layer)) < TOL_F32
        assert max_err(out, jax_multi(case, layer, pallas=True)) < TOL_F32
        assert float(out[3].abs().max()) == 0.0     # the dead slot


@pytest.mark.parametrize("Q", [1, 4, 5])
@pytest.mark.parametrize("G", [1, 2])
def test_multi_ref_rows_equal_single_token_reads(Q, G):
    """Row r of a window at length S is the decode read at length
    S - (Q-1-r): the verify is Q successive decode reads. Q = 1 is
    ``paged_attention_ref`` itself."""
    bs = 4
    case = multi_case(40 + Q + G, lengths=[Q, Q + 3, 12, 0], Q=Q, H=2 * G,
                      Hkv=2, Dh=16, L=2, bs=bs)
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in case)
    out = paged_attention_multi_ref(q, kp, vp, tables, lengths, 1)
    for r in range(Q):
        row = paged_attention_ref(q[:, r].contiguous(), kp, vp, tables,
                                  lengths - (Q - 1 - r), 1)
        assert float((out[:, r] - row).abs().max()) < 1e-6
    if Q == 1:
        assert torch.equal(out[:, 0], paged_attention_ref(
            q[:, 0].contiguous(), kp, vp, tables, lengths, 1))


def test_multi_ref_rows_with_nothing_to_attend_and_overshoot():
    """A window longer than its slot's length leaves its first rows nothing
    to attend (zeros, as the JAX oracle gives); a window whose last rows
    run past the table's coverage sees the covered positions only, as the
    oracle's gather does; aliased pages read the same either way."""
    bs, Q = 4, 4
    wide = multi_case(3, lengths=[2, 9, 14, 7], Q=Q, H=6, Hkv=2, Dh=16, L=2,
                      bs=bs, alias=True)
    q, kp, vp, tables, lengths = wide
    case = (q, kp, vp, np.ascontiguousarray(tables[:, :3]), lengths)
    out = port(case, 1, fn=paged_attention_multi_ref)
    assert float(out[0, :2].abs().max()) == 0.0     # limits -1 and 0
    assert float(out[0, 2:].abs().min()) > 0.0
    assert max_err(out, jax_multi(case, 1)) < TOL_F32
    # slot 2's rows reach positions 11..14 but the narrowed table covers
    # 12: each row equals a decode read of the full table clamped to 12
    tq, tk, tv, tt, tl = (torch.from_numpy(a) for a in wide)
    for r in range(Q):
        row = paged_attention_ref(tq[:, r].contiguous(), tk, tv, tt,
                                  torch.clamp(tl - (Q - 1 - r), 0, 3 * bs),
                                  1)
        assert float((out[:, r] - row).abs().max()) < 1e-6


def test_multi_ref_ignores_garbage_past_row_lengths():
    """Write-then-mask: K/V at or past each slot's length (rejected
    speculative candidates) must not reach any row. Poisoning them with huge
    values changes no bit of the output."""
    bs = 4
    case = multi_case(13, lengths=[5, 9], Q=3, H=2, Hkv=2, Dh=16, L=1,
                      bs=bs, n_pages=3)
    q, kp, vp, tables, lengths = case
    clean = port(case, 0, fn=paged_attention_multi_ref)
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(2):
        for pos in range(int(lengths[b]), 3 * bs):
            blk = tables[b, pos // bs]
            kp2[blk, pos % bs], vp2[blk, pos % bs] = 1e6, -1e6
    poisoned = port((q, kp2, vp2, tables, lengths), 0,
                    fn=paged_attention_multi_ref)
    assert torch.equal(poisoned, clean)


def test_multi_ref_bf16_matches_jax_ref():
    """smollm-360m's heads and head_dim at k = 3."""
    bs, Q = 16, 4
    case = multi_case(5, lengths=window_lengths(Q, bs), Q=Q, H=15, Hkv=5,
                      Dh=64, L=2, bs=bs)
    out = port(case, 1, dtype=torch.bfloat16, fn=paged_attention_multi_ref)
    assert out.dtype == torch.bfloat16
    assert bf16_excess(out.float(), jax_multi(case, 1, jnp.bfloat16)) <= 0


def test_multi_wrapper_cpu_dispatch_and_bad_arguments():
    """CPU tensors go to the plain version (bitwise, no launch counted);
    the wrapper takes a window of any size and rejects what the kernel does
    not take."""
    case = multi_case(7, lengths=[5, 0, 12], Q=4, H=6, Hkv=2, Dh=16, L=2,
                      bs=4)
    before = paged_attention_multi.launches
    out = port(case, 1, fn=paged_attention_multi)
    assert torch.equal(out, port(case, 1, fn=paged_attention_multi_ref))
    assert paged_attention_multi.launches == before
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in case)
    with pytest.raises(ValueError, match=r"\[B, Q, H, Dh\]"):
        paged_attention_multi(q[:, 0], kp, vp, tables, lengths, 0)
    with pytest.raises(ValueError, match="window"):
        paged_attention_multi(q[:, :0], kp, vp, tables, lengths, 0)
    # any window: Q = 12, and 8 x 9 = 72 rows per KV head, which the kernel
    # cuts into tiles of 64
    wide = torch.ones((3, 8, 18, 16))
    for big in (q.repeat(1, 3, 1, 1), wide):
        assert torch.equal(
            paged_attention_multi(big, kp, vp, tables, lengths, 0),
            paged_attention_multi_ref(big, kp, vp, tables, lengths, 0))
    with pytest.raises(TypeError):
        paged_attention_multi(q, kp, vp, tables, lengths.long(), 0)
    with pytest.raises(ValueError, match="layer"):
        paged_attention_multi(q, kp, vp, tables, lengths, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_multi(q.transpose(0, 1).contiguous().transpose(0, 1),
                              kp, vp, tables, lengths, 0)


def test_kernel_oracles_registry_self_test():
    assert KERNEL_ORACLES["paged_attention"][0] == "paged_attention_ref"
    assert KERNEL_ORACLES["paged_attention_multi"][0] == \
        "paged_attention_multi_ref"
    assert check_kernel_oracles() == []
    broken = {"paged_attention": ("no_such_ref", "tests/no_such_test.py"),
              "ghost_kernel": ("paged_attention_ref",
                               "tests/test_torch_kernels.py")}
    problems = check_kernel_oracles(broken)
    assert any("no_such_ref" in p for p in problems)
    assert any("no_such_test.py" in p for p in problems)
    assert any(p.startswith("ghost_kernel") for p in problems)
    assert "ghost_kernel: no ghost_kernel_launch entry point in csrc/" \
        in problems
    assert check_kernel_oracles({}) == [
        f"csrc/{name}.cu has no KERNEL_ORACLES entry"
        for name in ("flash_attention", "paged_attention", "rglru_scan",
                     "wkv6_scan")]
