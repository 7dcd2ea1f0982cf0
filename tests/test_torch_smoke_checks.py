"""The checks of ``chip_smoke.py`` that need no card, on synthetic inputs.

The profiled drains' traced-launch check (``check_trace``) must pass a
complete trace and fail when the trace lost launches, when a kernel was
not launched, when its plain version ran in its place and when a kernel of
another path ran. The SASS check must fail when a bf16 flash-attention
instantiation holds no tensor-core instruction. The WKV bound and the launch count a
continuous rwkv6 drain must make are worked out from shapes. JAX-free.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

WANT = {"wkv6_scan": 576}
COUNTED = {name: WANT.get(name, 0) for name in smoke.KERNEL_SYMBOLS}


def rows(wkv=576, extra=()):
    """A trace's device rows (name, ms, count) other than the window's
    spins: some library kernels, the WKV kernel ``wkv`` times, and
    ``extra``."""
    out = [("void at::native::elementwise_kernel<...>", 19.7, 7528),
           ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", 19.8, 3072),
           ("void (anonymous namespace)::wkv6_scan_kernel<__nv_bfloat16, "
            "64>(...)", 8.9, wkv), *extra]
    return [r for r in out if r[2]]


def test_complete_trace_passes():
    traced = smoke.check_trace(rows(), COUNTED, WANT, "[t]")
    assert traced["wkv6_scan"] == 576
    assert sum(traced.values()) == 576


def test_trace_that_lost_launches_fails():
    """smoke runs before the repair traced 563 of 576 counted launches."""
    with pytest.raises(AssertionError, match="traced"):
        smoke.check_trace(rows(wkv=563), COUNTED, WANT, "[t]")


def test_plain_version_in_the_kernels_place_fails():
    """The plain version launches no kernel of ours: the wrapper counts
    nothing and the trace shows nothing."""
    zero = dict(COUNTED, wkv6_scan=0)
    with pytest.raises(AssertionError, match="counted"):
        smoke.check_trace(rows(wkv=0), zero, WANT, "[t]")
    with pytest.raises(AssertionError, match="traced"):
        smoke.check_trace(rows(wkv=0), COUNTED, WANT, "[t]")


def test_kernel_of_another_path_fails():
    other = (("void (anonymous namespace)::rglru_scan_kernel<float>(...)",
              0.5, 18),)
    with pytest.raises(AssertionError, match="traced"):
        smoke.check_trace(rows(extra=other), COUNTED, WANT, "[t]")


def test_wkv_bound_at_the_prefill_and_decode_shapes():
    """Prefill (B 1, S 2 300, H 32, Dh 64, bf16): 5 * 2 300 * 32 * 64 * 65
    f32 operations (5 per state element, 5 per channel) over 67 TFLOP/s,
    0.02285 ms, outweigh ~57 MB over 3.35 TB/s, 0.0170 ms. Decode (B 4, S 1,
    from a state): the states' 2 * 4 * 32 * 64**2 * 4 bytes bound it."""
    r = torch.empty((1, 2300, 32, 64), dtype=torch.bfloat16)
    ms, by = smoke.wkv_bound_ms(r, state=False)
    assert by == "operations"
    assert ms == pytest.approx(5 * 2300 * 32 * 64 * 65 / 67e12 * 1e3)
    assert ms == pytest.approx(0.02285, abs=1e-5)
    r = torch.empty((4, 1, 32, 64), dtype=torch.bfloat16)
    ms, by = smoke.wkv_bound_ms(r, state=True)
    n = 4 * 32 * 64
    want = (12 * n + 4 * 32 * 64 + 2 * 4 * 4 * 32 * 64 ** 2) / 3.35e12 * 1e3
    assert by == "bytes" and ms == pytest.approx(want)


def test_ssm_drain_launches_and_the_plain_counter():
    from repro_torch.configs import get
    from repro_torch.kernels import ref, wkv6_scan_ref

    cfg = get("rwkv6-1.6b").config
    assert smoke.ssm_want(cfg, {"prefills": 8, "decode_steps": 32}) == \
        {"wkv6_scan": 24 * 40}
    args = [torch.zeros((1, 3, 1, 64)) for _ in range(4)] + \
        [torch.zeros((1, 64))]
    with smoke.counting(ref, "_wkv_recurrence") as calls:
        wkv6_scan_ref(*args)
        wkv6_scan_ref(*args)
    assert calls == [2]
    assert ref._wkv_recurrence.__name__ == "_wkv_recurrence"


def test_device_records_fallback_reads_the_same_records():
    """The trace parse reads the profiler's raw result and, where a torch
    release lacks it, ``prof.events()``: both give the same records. Run on
    a CPU trace, with the CPU standing in for the card's device type."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            x = torch.mm(x, x) * 0.5
    host = SimpleNamespace(autograd=SimpleNamespace(
        DeviceType=SimpleNamespace(CUDA=torch.autograd.DeviceType.CPU)))
    raw = smoke.device_records(host, prof)
    fallback = smoke.device_records(host, SimpleNamespace(events=prof.events))
    assert sum(name == "aten::mm" for name, _ in raw) == 3
    assert sorted(n for n, _ in raw) == sorted(n for n, _ in fallback)

    def by_name(recs):
        return {n: sum(d for m, d in recs if m == n) for n, _ in recs}

    want, got = by_name(raw), by_name(fallback)
    assert all(abs(want[n] - got[n]) <= 10 for n in want)


def sass(hmma_at=(32, 64, 128, 256)):
    """``cuobjdump -sass`` text of the flash library: each instantiation's
    function line, two FFMA lines, and for the bf16 head dims in
    ``hmma_at`` an HMMA line."""
    out = []
    for dtype, tail in (("13__nv_bfloat16", "S4_S4_PS2_"), ("f", "S3_S3_PS1_")):
        for dh in (256, 128, 64, 32):
            out.append(f"\t\tFunction : _ZN51_GLOBAL__N__e7510225_18_flash_"
                       f"attention_cu_23f0aea722flash_attention_kernelI"
                       f"{dtype}Li{dh}EEEvPKT_{tail}iiiiNS_7StridesEiif")
            out += ["        /*7790*/  FFMA R214, R214, R235, R227 ;"] * 2
            if dtype != "f" and dh in hmma_at:
                out.append("        /*41c0*/  HMMA.16816.F32.BF16 R12, R64, "
                           "R4, RZ ;")
    return "\n".join(out)


def test_sass_check_needs_hmma_in_every_bf16_flash_body():
    counts = smoke.sass_counts(sass())
    assert counts["flash_attention_kernel<bf16, 64>"] == (1, 2)
    assert counts["flash_attention_kernel<f32, 256>"] == (0, 2)
    assert len(smoke.check_sass(counts)) == 8
    with pytest.raises(AssertionError, match="bf16, 128"):
        smoke.check_sass(smoke.sass_counts(sass(hmma_at=(32, 64, 256))))
    missing = {k: v for k, v in counts.items() if "bf16, 32>" not in k}
    with pytest.raises(AssertionError, match="not found"):
        smoke.check_sass(missing)


def test_chain_check_holds_the_plain_scan_and_fails_a_cut_dependent_one():
    """The prefill-then-decode chain check passes the plain WKV scan, whose
    steps do not depend on where a sequence is cut, and fails a scan whose
    y does (here: rounded differently for a one-step call)."""
    from repro_torch.kernels import wkv6_scan_ref

    g = torch.Generator().manual_seed(0)
    r, k, v, wn = (torch.randn((1, 9, 2, 64), generator=g) for _ in range(4))
    args = [r, k, v, 0.98 * torch.sigmoid(wn),
            0.1 * torch.randn((2, 64), generator=g), None]
    assert smoke.chains_bitwise(torch, wkv6_scan_ref, args, 8)

    def cut_dependent(r, k, v, w, u, s0=None):
        y, s_t = wkv6_scan_ref(r, k, v, w, u, s0)
        return (y.bfloat16().float() if r.shape[1] == 1 else y), s_t

    assert not smoke.chains_bitwise(torch, cut_dependent, args, 8)
