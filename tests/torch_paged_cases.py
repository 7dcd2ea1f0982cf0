"""Paged-attention test cases shared by the port's CPU and CUDA kernel
tests. numpy only, so the CUDA tests run where JAX is not installed."""
import numpy as np

# f32: both sides take one full softmax in f32 over the same values; only
# the order of the f32 sums differs (einsum vs XLA dot, or the Pallas
# kernel's page-by-page online softmax), a few ulp at these sizes.
TOL_F32 = 2e-5
# bf16: both compute in f32 and round the output to bf16 once, so an
# element can differ by one rounding step: one bf16 ulp, at most 2**-7 of
# |ref|. The limit is two such ulps of each element's reference, plus
# BF16_ATOL for outputs near zero, where the order of the f32 sums (a few
# f32 ulps of O(1) terms) outweighs a bf16 ulp of the output. At |out| ~ 0.1
# (softmax over hundreds of random positions) that is ~1.7e-3, below the
# ~1e-2 that one wrongly masked position on a long slot would cost.
BF16_RTOL = 2 ** -6
BF16_ATOL = 1e-4


def bf16_excess(out, ref):
    """Largest amount by which ``|out - ref|`` exceeds its bf16 limit
    ``BF16_ATOL + BF16_RTOL * |ref|``; at most 0 when every element is
    within it."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.max(np.abs(out - ref)
                        - (BF16_ATOL + BF16_RTOL * np.abs(ref))))


def paged_case(seed, *, B_lengths, H, Hkv, Dh, L, bs, extra_blocks=2,
               n_pages=None, alias=False):
    """Random pool + a permuted, trash-padded table for each slot length.

    With ``alias=True`` slot 1 shares slot 0's full pages (as a shared
    prompt prefix would), then continues on pages of its own."""
    rng = np.random.default_rng(seed)
    lengths = list(B_lengths)
    B = len(lengths)
    pages = [-(-n // bs) for n in lengths]
    n_pages = n_pages or max(max(pages), 1)
    shared = lengths[0] // bs if alias else 0
    num_blocks = sum(pages) - shared + extra_blocks
    kp = rng.standard_normal((num_blocks + 1, bs, L, Hkv, Dh), np.float32)
    vp = rng.standard_normal((num_blocks + 1, bs, L, Hkv, Dh), np.float32)
    q = rng.standard_normal((B, H, Dh), np.float32)
    order = list(rng.permutation(num_blocks))
    tables = np.full((B, n_pages), num_blocks, np.int32)
    for i, used in enumerate(pages):
        for j in range(used):
            if alias and i == 1 and j < shared:
                tables[i, j] = tables[0, j]
            else:
                tables[i, j] = order.pop()
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def tail_lengths(bs):
    """Every tail-offset class: 1 position, bs-1, exactly bs, bs+1, a dead
    slot, and a long slot ending mid-page."""
    return [1, bs - 1, bs, bs + 1, 0, 3 * bs + bs // 2]


def multi_case(seed, *, lengths, Q, H, Hkv, Dh, L, bs, n_pages=None,
               alias=False, cover=None):
    """A verify window: q ``[B, Q, H, Dh]`` over :func:`paged_case`'s pool
    and tables. ``cover`` narrows the tables to that many pages, so the last
    rows of a window longer than ``cover * bs`` run past the table (the
    engine's trash-routed overshoot)."""
    _, kp, vp, tables, lens = paged_case(seed, B_lengths=lengths, H=H,
                                         Hkv=Hkv, Dh=Dh, L=L, bs=bs,
                                         n_pages=n_pages, alias=alias)
    q = np.random.default_rng(seed + 1).standard_normal(
        (len(lengths), Q, H, Dh), np.float32)
    if cover is not None:
        tables = np.ascontiguousarray(tables[:, :cover])
    return q, kp, vp, tables, lens


def window_lengths(Q, bs):
    """Windows ending at every tail-offset class: exactly Q (row 0 sees one
    position), a window crossing a page boundary, ending on one, a dead
    slot, and a long slot ending mid-page."""
    return [Q, bs + Q // 2 + 1, 2 * bs, 0, 3 * bs + bs // 2]
