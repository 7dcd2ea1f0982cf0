"""The port's dry run (``repro_torch.launch.dryrun``) and the trainer's
dry-run helpers against the JAX package's: ``state_shape`` and
``step_batch_specs`` shapes and dtypes equal the JAX ``eval_shape``s for
every family's reduced config (MDBO and VRDBO); the dry run at full width
on the debug mesh for the JAX package's three integration pairs; the
dry run's inputs and flops equal to a real step's on the CPU; the
``--torch-profile`` flag; the paths that still wait on item 6."""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.train import decentral as jdec  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.common import replicate  # noqa: E402
from repro_torch.core.engine import _unaliased, make_mix  # noqa: E402
from repro_torch.data import make_lm_step_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.obs import torch_profile  # noqa: E402
from repro_torch.train import TrainerConfig, make_trainer_engine  # noqa: E402
from repro_torch.train import decentral  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FAMILIES = ["smollm-360m", "recurrentgemma-2b", "rwkv6-1.6b",
            "phi3.5-moe-42b-a6.6b", "chameleon-34b", "whisper-tiny"]


def shapes_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return sorted((jax.tree_util.keystr(p), tuple(s.shape),
                   np.dtype(s.dtype).name) for p, s in flat)


def shapes_port(tree):
    flat = pytree.tree_flatten_with_path(tree)[0]
    return sorted((pytree.keystr(p), tuple(t.shape),
                   str(t.dtype).removeprefix("torch.")) for p, t in flat)


@pytest.mark.parametrize("algo", ["mdbo", "vrdbo"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_state_and_batch_specs_equal_reference(arch, algo):
    cfg, jcfg = get(arch).reduced(), jget(arch).reduced()
    tc = TrainerConfig(algo=algo)
    jtc = jdec.TrainerConfig(algo=algo)
    K, per_node, seq = 4, 2, 16
    st = decentral.state_shape(cfg, tc, K)
    jst = jdec.state_shape(jcfg, jtc, K)
    assert type(st).__name__ == type(jst).__name__
    assert st._fields == jst._fields
    assert shapes_port(st) == shapes_jax(jst)
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(st))
    b = decentral.step_batch_specs(cfg, tc, K, per_node, seq)
    jb = jdec.step_batch_specs(jcfg, jtc, K, per_node, seq)
    # the port's tokens are int64 (torch's index dtype), the JAX ones int32
    want = [(p, s, "int64" if d == "int32" and "image_pos" not in p else d)
            for p, s, d in shapes_jax(jb)]
    assert shapes_port(b) == want


def test_node_keys_spec_and_placement():
    k = decentral.node_keys_spec(4)
    jk = jdec.node_keys_spec(4)
    assert (tuple(k.shape), k.dtype, k.device.type) == ((4,), torch.int64,
                                                         "meta")
    # J̃ [K] int64 against (K, 2) uint32 keys: 8·K bytes either way
    assert k.numel() * k.element_size() == np.prod(jk.shape) * 4 == 32
    mesh = make_debug_mesh(multi_pod=True)
    assert decentral.n_nodes(get("smollm-360m"), mesh) == 2
    assert decentral.n_nodes(get("grok-1-314b"), mesh) == 2
    assert decentral.node_axis_name(get("grok-1-314b")) == "pod"
    assert decentral.node_axis_name(get("qwen2.5-3b")) == "data"


def test_mesh_engine_and_ring_local_still_wait_on_item_6():
    cfg = get("smollm-360m").reduced()
    with pytest.raises(NotImplementedError, match="item 6"):
        make_trainer_engine(cfg, TrainerConfig(), 2,
                            mesh=make_debug_mesh(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        make_mix("ring_local", K=2, device="cpu")


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "train_4k"),
    ("rwkv6-1.6b", "decode_32k"),
    ("whisper-tiny", "prefill_32k"),
])
def test_debug_mesh_dryrun(tmp_path, arch, shape):
    """Full width, the 2x2 debug mesh (the JAX package's
    ``tests/test_dryrun_integration.py`` pairs): the serving pairs through
    the CLI; the train pair at train_4k's K (the data axis's 2 nodes) and
    per-node batch (128) but 512 tokens: one query chunk of the attention
    and one of the loss, where 4 096 tokens run eight of each, the same
    operators (the whole trace takes ~37 s on a CPU core)."""
    spec = get(arch)
    if shape == "train_4k":
        st = dryrun.build_train(spec, dryrun.SHAPES[shape],
                                make_debug_mesh(), TrainerConfig())
        assert st.args[1]["f"]["tokens"].shape == (2, 128, 4096)
        dryrun.run_pair(arch, mesh=make_debug_mesh(),
                        train_shape=(2, 128, 512), out_dir=str(tmp_path),
                        verbose=False)
        name = f"{arch}__train_2x128x512__2x2.json"
    else:
        dryrun.main(["--arch", arch, "--shape", shape, "--debug-mesh",
                     "--out-dir", str(tmp_path)])
        name = f"{arch}__{shape}__2x2.json"
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert files == [name]
    d = json.loads((tmp_path / files[0]).read_text())
    rl = d["roofline"]
    assert rl["flops_per_device"] > 0
    assert rl["hbm_bytes_per_device"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert d["memory"]["temp_bytes"] > 0
    assert 0 < d["memory"]["argument_bytes"] < d["global"]["argument_bytes"]
    assert d["compile_s"] is None and d["xla_cost_reference"] is None
    assert d["n_chips"] == 4 and d["kind"] == shape.split("_")[0]
    # the dp trainer's nodes sit on the data axis: the ring crosses devices
    assert (rl["collective_bytes_per_device"] > 0) == (shape == "train_4k")


def test_act_model_waits_on_item_6(tmp_path):
    """The JAX dry run's activation-sharding variant changes the compiled
    placement; the port's would change no count, so it raises."""
    with pytest.raises(NotImplementedError, match="item 6"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--debug-mesh", "--act-model",
                     "--out-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 6"):
        dryrun.run_pair("smollm-360m", "decode_32k", mesh=make_debug_mesh(),
                        variant={"act_model": True}, out_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-tiny"])
def test_dry_run_counts_a_real_step(tmp_path, arch):
    """The one-card mesh at a reduced trainer shape (chip_smoke.py phase
    18's check on the CPU): the inputs' bytes equal the engine's state
    (after its init, each leaf its own tensor), step batch and J̃; the
    flops equal FlopCounterMode's count of one real per_step step."""
    K, per_node, seq = 4, 2, 8
    d = dryrun.run_pair(arch, mesh=make_debug_mesh(data=1, model=1),
                        tc=TrainerConfig(mix="ring"),
                        train_shape=(K, per_node, seq), reduced=True,
                        out_dir=str(tmp_path), verbose=False)
    assert d["n_chips"] == 1 and d["collectives"]["total_bytes"] == 0
    cfg = get(arch).reduced()
    tc = TrainerConfig(mix="ring")
    problem, eng = make_trainer_engine(cfg, tc, K, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def draw():
        return (make_lm_step_batch(cfg, gen, K, per_node, seq, J=tc.J),
                torch.randint(0, tc.J, (K,), generator=gen))

    state = _unaliased(eng.init(replicate(problem.init_x(gen, "cpu"), K),
                                replicate(problem.init_y(gen, "cpu"), K),
                                *draw()))
    batch, jt = draw()
    got = sum(t.nbytes for t in pytree.tree_leaves((state, batch, jt)))
    assert got == d["global"]["argument_bytes"] == \
        d["memory"]["argument_bytes"]
    with FlopCounterMode(display=False) as counter:
        eng.step(state, batch, jt)
    assert counter.get_total_flops() == d["global"]["flops"] == \
        d["roofline"]["flops_per_device"]
    # phase 18's pass factor: K x (9 + 9 J) forwards a node (found 26.36
    # smollm, 26.47 whisper for 27)
    factor = d["global"]["flops"] / (K * smoke.forward_flops(cfg, per_node,
                                                             seq))
    assert abs(factor / (9 + 9 * tc.J) - 1) <= smoke.DRY_FACTOR_RTOL


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-tiny"])
def test_forward_flops_count_the_matrix_products(arch):
    """``chip_smoke.forward_flops``, the phase's count by hand, against
    FlopCounterMode over one full-width ``loss_fn`` forward on meta
    tensors at the phase's per-node batch (2 x 32 tokens)."""
    cfg = get(arch).config
    params = dryrun._serve_params(get(arch), cfg, make_debug_mesh())[0]
    B, S = 2, 32
    batch = {k: torch.empty((B, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    if cfg.is_encdec:
        batch["src_embeds"] = torch.empty((B, cfg.src_len, cfg.d_model),
                                          dtype=cfg.dtype, device="meta")
    with FlopCounterMode(display=False) as counter:
        loss_fn(cfg, params, batch)
    assert counter.get_total_flops() == smoke.forward_flops(cfg, B, S)


def test_torch_profile(tmp_path):
    with pytest.raises(SystemExit, match="--trace-dir"):
        train_cli.main(["--arch", "smollm-360m", "--reduced", "--device",
                        "cpu", "--torch-profile"])
    with torch_profile(str(tmp_path / "tr")):
        torch.ones(8) @ torch.ones(8)
    trace = json.loads((tmp_path / "tr" / "torch_profile.json").read_text())
    assert any("aten::" in e.get("name", "")
               for e in trace["traceEvents"])
