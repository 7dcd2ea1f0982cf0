"""``chip_smoke.py`` phase 18's checks at ``.reduced()`` size on the card:
the dry run of the trainer's step (``repro_torch.launch.dryrun``, one-card
mesh) held against the same step run on the card (inputs' bytes and flops
exactly, the peak within the phase's limit, a replayed step no faster than
the compute bound), and ``adamw`` + ``clip_by_global_norm`` on the card
against the CPU. JAX-free, so it runs on a GPU host without JAX:

  PYTHONPATH=src python -m pytest --noconftest -m cuda \\
      tests/test_torch_dryrun_cuda.py

Every test skips without a card. Full width is ``chip_smoke.py`` phase 18.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# a reduced trainer shape whose step outweighs the allocator's rounding
K, PER_NODE, SEQ = 4, 4, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(smoke.DRY_ARCHS))
def test_dry_run_holds_against_the_card(cuda_device, arch):
    dry = smoke.dry_run_worker([arch], (K, PER_NODE, SEQ), reduced=True)
    r = smoke.dry_step_check(torch, get(arch).reduced(), dry[arch], K,
                             PER_NODE, SEQ, f"[{arch}]", replays=3)
    assert r["flops"] == dry[arch]["global"]["flops"] > 0
    assert r["replayed_step_s"] >= r["t_compute_s"]
    assert 0 < r["bound_over_measured"]


@pytest.mark.cuda
def test_adamw_on_the_card_matches_the_cpu(cuda_device):
    assert smoke.optim_check(torch) <= smoke.OPT_RTOL
