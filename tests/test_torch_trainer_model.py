"""The port's training path vs the JAX package's, on identical weights:
``forward`` (logits, final hidden states and the MoE aux losses),
``chunked_ce`` (S a multiple of the chunk, and not), ``loss_fn`` (with the
MoE aux terms), its gradient, the Hessian-vector product of the LM bilevel
problem's lower loss, ``_layer_reg`` and ``x_dim``, for every family.

Each family is its ``.reduced()`` config cut further to narrow widths
(d_model 32, two heads of 16, d_ff 64, vocab 64, f32): the dense family at 2
layers, the hybrid at 4 (one stacked block and a trailing ``rem``
layer, with a local window of 8 that the 12-token rows run past), the ssm
at 2, the moe (phi3.5-moe) at 2 with 4 experts top-2, jointly routed in one
group and in ``moe_groups`` 2, the vlm (chameleon) at 2 with 4 image
tokens, the audio (whisper) at 2 + 2 layers over 16 frames. The JAX tree is
initialised by ``repro.models.init_params`` and carried over with
``params_from_jax``; tokens come from the JAX package's ``lm_batch``, the
vlm and audio extras from its ``vision_stub`` and ``audio_stub``
(``repro.data.lm.lm_batch_extras``). The JAX side is computed once per
family (a module-scoped fixture).

Tolerances (f32, the two frameworks sum products in other orders):
logits and hidden states (O(1)) within TOL_ACT absolute; the losses and the
MoE aux losses within TOL_LOSS; gradients and HVPs within TOL_GRAD of each
leaf's largest magnitude; ``_layer_reg`` within 1e-6 relative. MoE routing
is discrete: a token routed to another expert in one package would move
its row by O(1), far past these limits. Measured at these sizes (all
seven cases): activations ≤ 1.9e-6, losses and aux losses ≤ 9.5e-7,
gradients ≤ 1.9e-6 and HVPs ≤ 3.1e-6 of the leaf's largest entry,
``_layer_reg`` ≤ 1.5e-7 relative.
"""
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs  # noqa: E402
import repro.data.lm as rdata_lm  # noqa: E402
import repro.models.transformer as rtf  # noqa: E402
import repro.train.bilevel_lm as rbl  # noqa: E402
import repro_torch.configs  # noqa: E402
import repro_torch.data.lm as pdata_lm  # noqa: E402
import repro_torch.models.transformer as ptf  # noqa: E402
import repro_torch.train.bilevel_lm as pbl  # noqa: E402
from repro.core.hypergrad import hvp_yy as rhvp  # noqa: E402
from repro.data.synthetic import lm_batch as rlm_batch  # noqa: E402
from repro_torch.core.hypergrad import hvp_yy as phvp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401

TOL_ACT, TOL_LOSS, TOL_GRAD = 1e-4, 1e-5, 1e-4
B, S = 2, 12
NARROW = dict(d_model=32, n_heads=2, head_dim=16, d_ff=64, vocab=64)
MOE = dict(NARROW, n_kv_heads=2, n_experts=4, top_k=2)
FAMILIES = {
    "dense": ("smollm-360m", dict(NARROW, n_kv_heads=2)),
    "hybrid": ("recurrentgemma-2b", dict(NARROW, n_kv_heads=1, n_layers=4,
                                         lru_width=32, local_window=8)),
    "ssm": ("rwkv6-1.6b", dict(NARROW, n_kv_heads=2)),
    "moe": ("phi3.5-moe-42b-a6.6b", MOE),
    "moe-groups": ("phi3.5-moe-42b-a6.6b", dict(MOE, moe_groups=2)),
    "vlm": ("chameleon-34b", dict(NARROW, n_kv_heads=2, n_img_tokens=4)),
    "audio": ("whisper-tiny", dict(NARROW, n_kv_heads=2, src_len=16)),
}


def configs(family):
    arch, kw = FAMILIES[family]
    return (repro.configs.get(arch).reduced().with_overrides(**kw),
            repro_torch.configs.get(arch).reduced().with_overrides(**kw))


EXTRAS = ("image_embeds", "image_pos", "src_embeds")


def t(a):
    return torch.from_numpy(np.array(a))


def extras(batch):
    """The batch's modality extras, as ``forward``'s keyword arguments."""
    return {k: batch[k] for k in EXTRAS if k in batch}


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, path=""):
    """{JAX keystr: leaf} of a port tree (dicts and lists)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}['{k}']"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{path}[{i}]"))
        return out
    return {path: tree.detach().numpy()}


def jflat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_tree_close(port, ref_tree, tol=TOL_GRAD):
    p, r = flat(port), jflat(ref_tree)
    assert p.keys() == r.keys()
    for k in r:
        scale = max(float(np.abs(r[k]).max()), 1e-30)
        np.testing.assert_allclose(p[k], r[k], rtol=0, atol=tol * scale,
                                   err_msg=k)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def case(request):
    """The JAX side of one family, computed once: its config, weights,
    batch, and every quantity the tests compare."""
    jcfg, tcfg = configs(request.param)
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(3))
    batch = rlm_batch(jax.random.PRNGKey(4), jcfg.vocab, B, S)
    batch.update(rdata_lm.lm_batch_extras(jcfg, jax.random.PRNGKey(6), B, S))
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(-2.0, 1.0, rbl.x_dim(jcfg)), jnp.float32)
    v = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jparams)
    problem = rbl.make_lm_bilevel_problem(jcfg)

    @jax.jit
    def reference(params, batch, x, v):
        """Every compared quantity in one compiled program."""
        kw = extras(batch)
        hidden, aux = rtf.forward(jcfg, params, batch["tokens"],
                                  return_hidden=True, **kw)
        return {
            "logits": rtf.forward(jcfg, params, batch["tokens"], **kw)[0],
            "hidden": hidden,
            "aux": aux,
            "ce4": rtf.chunked_ce(jcfg, params, hidden, batch["labels"], 4),
            "ce5": rtf.chunked_ce(jcfg, params, hidden, batch["labels"], 5),
            "loss": rtf.loss_fn(jcfg, params, batch),
            "grad": jax.grad(lambda p: rtf.loss_fn(jcfg, p, batch))(params),
            "hvp": rhvp(problem.lower_loss, x, params, batch, v),
            "reg": rbl._layer_reg(jcfg, x, params),
        }

    ref_out = {**reference(jparams, batch, x, v), "x_dim": rbl.x_dim(jcfg)}
    port = {
        "cfg": tcfg,
        "params": params_from_jax(to_np(jparams), device="cpu"),
        "batch": {k: t(b) for k, b in batch.items()},
        "x": t(x),
        "v": params_from_jax(to_np(v), device="cpu"),
    }
    return request.param, port, to_np(ref_out)


def test_forward_logits_and_hidden_states(case):
    """And the MoE aux losses, each summed over the layers; the other
    families return none."""
    family, p, r = case
    kw = extras(p["batch"])
    logits, aux = ptf.forward(p["cfg"], p["params"], p["batch"]["tokens"],
                              **kw)
    hidden, haux = ptf.forward(p["cfg"], p["params"], p["batch"]["tokens"],
                               return_hidden=True, **kw)
    assert logits.shape == (B, S, p["cfg"].vocab)
    assert aux.keys() == haux.keys() == r["aux"].keys() == (
        {"moe_lb", "moe_z"} if family.startswith("moe") else set())
    for name in r["aux"]:
        assert aux[name].shape == ()
        np.testing.assert_allclose(float(aux[name]), r["aux"][name], rtol=0,
                                   atol=TOL_LOSS)
    np.testing.assert_allclose(logits.numpy(), r["logits"], rtol=0,
                               atol=TOL_ACT)
    np.testing.assert_allclose(hidden.numpy(), r["hidden"], rtol=0,
                               atol=TOL_ACT)


@pytest.mark.parametrize("chunk", [4, 5], ids=["multiple", "fallback"])
def test_chunked_ce(case, chunk):
    """S = 12: chunks of 4, and 5, which does not divide S, so both
    packages fall back to one chunk of S."""
    _, p, r = case
    hidden, _ = ptf.forward(p["cfg"], p["params"], p["batch"]["tokens"],
                            return_hidden=True, **extras(p["batch"]))
    ce = ptf.chunked_ce(p["cfg"], p["params"], hidden, p["batch"]["labels"],
                        chunk)
    assert ce.dtype == torch.float32 and ce.shape == ()
    np.testing.assert_allclose(float(ce), r[f"ce{chunk}"], rtol=0,
                               atol=TOL_LOSS)


def test_loss_fn_and_its_gradient(case):
    """The moe family's loss adds ``0.01 moe_lb + 0.001 moe_z`` to the
    cross-entropy."""
    family, p, r = case
    loss = ptf.loss_fn(p["cfg"], p["params"], p["batch"])
    np.testing.assert_allclose(float(loss), r["loss"], rtol=0, atol=TOL_LOSS)
    if family.startswith("moe"):
        ce = r["ce4"]
        want = ce + 0.01 * r["aux"]["moe_lb"] + 0.001 * r["aux"]["moe_z"]
        np.testing.assert_allclose(float(loss), want, rtol=0, atol=TOL_LOSS)
        assert abs(float(loss) - ce) > 10 * TOL_LOSS
    grad = torch.func.grad(lambda q: ptf.loss_fn(p["cfg"], q, p["batch"]))(
        p["params"])
    assert_tree_close(grad, r["grad"])


def test_hvp_of_the_lower_loss(case):
    """∇²_yy g · v by ``torch.func.jvp`` of ``grad`` through the whole
    model, against the JAX package's forward-over-reverse."""
    _, p, r = case
    problem = pbl.make_lm_bilevel_problem(p["cfg"])
    hv = phvp(problem.lower_loss, p["x"], p["params"], p["batch"], p["v"])
    assert_tree_close(hv, r["hvp"])


def test_layer_reg_and_x_dim(case):
    """The hybrid family's ``rem`` layer lands in the x[-1] bucket with the
    embedding and the final norm."""
    family, p, r = case
    assert pbl.x_dim(p["cfg"]) == r["x_dim"] == (2 if family == "hybrid"
                                                 else 3)
    reg = pbl._layer_reg(p["cfg"], p["x"], p["params"])
    assert reg.dtype == torch.float32
    np.testing.assert_allclose(float(reg), r["reg"], rtol=1e-6, atol=0)
    if family == "hybrid":
        assert len(p["params"]["rem"]) == 1
        # moving a rem weight moves the reg by exp(x[-1]) times its mean
        # square change, and x[:n] do not weigh it
        bumped = {**p["params"], "rem": [
            {**p["params"]["rem"][0], "norm1": {"scale": p["params"]["rem"][
                0]["norm1"]["scale"] + 1.0}}]}
        s = p["params"]["rem"][0]["norm1"]["scale"]
        want = torch.exp(p["x"][-1]) * (torch.mean((s + 1) ** 2)
                                        - torch.mean(s ** 2))
        got = pbl._layer_reg(p["cfg"], p["x"], bumped) - reg
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("n_enc", [2, 3], ids=["shared", "apart"])
def test_layer_reg_weighs_the_encoder_layers_as_the_reference(n_enc):
    """The audio family's ``enc_layers`` name ``layers``: with
    ``n_enc_layers == n_layers`` (whisper-tiny's 4 + 4; 2 + 2 here) encoder
    layer i shares x[i] with decoder layer i, with 3 + 2 every encoder leaf
    goes to x[-1], in both packages."""
    arch, kw = FAMILIES["audio"]
    jcfg, tcfg = (get(arch).reduced().with_overrides(**kw, n_enc_layers=n_enc)
                  for get in (repro.configs.get, repro_torch.configs.get))
    jparams = repro.models.init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_jax(to_np(jparams), device="cpu")
    x = np.random.default_rng(5).normal(-2.0, 1.0,
                                        rbl.x_dim(jcfg)).astype(np.float32)
    reg = pbl._layer_reg(tcfg, t(x), params)
    np.testing.assert_allclose(float(reg), float(rbl._layer_reg(
        jcfg, jnp.asarray(x), jparams)), rtol=1e-6, atol=0)
    # moving encoder layer 0's norm scale moves the reg by its weight times
    # the mean square change over the leaf it is averaged in
    s = params["enc_layers"]["norm1"]["scale"]
    bumped_s = s.clone()
    bumped_s[0] += 1.0
    enc = {**params["enc_layers"], "norm1": {**params["enc_layers"]["norm1"],
                                             "scale": bumped_s}}
    change = torch.sum(bumped_s[0] ** 2) - torch.sum(s[0] ** 2)
    weight, count = ((t(x)[0], s[0].numel()) if n_enc == tcfg.n_layers
                     else (t(x)[-1], s.numel()))
    got = pbl._layer_reg(tcfg, t(x), {**params, "enc_layers": enc}) - reg
    np.testing.assert_allclose(float(got),
                               float(torch.exp(weight) * change / count),
                               rtol=1e-4)


def test_gradient_under_vmap_is_the_same_every_call():
    """The vmapped gradient through the embedding sums repeated tokens in a
    fixed order (the one-hot product), so two calls agree bit for bit —
    what makes fused and per-step runs equal. (Indexing's derivative,
    under ``vmap``, did not: the table's gradient changed call to call.)"""
    # the reduced widths: at the narrow ones the CPU's scatter was steady
    cfg = repro_torch.configs.get("smollm-360m").reduced()
    params = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 16, (4, 2, 32), generator=gen)  # repeats
    batch = {"tokens": tokens, "labels": tokens}

    def grads():
        return torch.func.vmap(lambda b: torch.func.grad(
            lambda q: ptf.loss_fn(cfg, q, b))(params))(batch)

    first, second = flat(grads()), flat(grads())
    assert all(np.array_equal(first[k], second[k]) for k in first)


def test_param_count_matches_the_reference(case):
    _, p, r = case
    assert ptf.param_count(p["params"]) == sum(
        a.size for a in jax.tree.leaves(r["grad"]))


def test_training_path_reaches_no_kernel_and_no_plain_version(monkeypatch):
    """The loss and its gradient run with every kernel wrapper's plain
    version made to raise; prefill, which the kernels carry, does not."""
    def refuse(*a, **k):
        raise AssertionError("a kernel's plain version ran")

    for name in ("attention_ref", "rglru_ref", "wkv6_scan_ref", "wkv6_ref"):
        monkeypatch.setattr(ref, name, refuse)
    # the wrappers' CPU dispatch holds its plain version by name
    for mod, name in (("flash_attention", "attention_ref"),
                      ("rglru_scan", "rglru_ref"),
                      ("wkv6_scan", "wkv6_scan_ref")):
        monkeypatch.setattr(
            importlib.import_module(f"repro_torch.kernels.{mod}"), name,
            refuse)
    archs = sorted({arch for arch, _ in FAMILIES.values()})
    assert len(archs) == len(ptf.FAMILIES)
    for arch in archs:
        # the reduced widths: the kernels' wrappers check head sizes first
        cfg = repro_torch.configs.get(arch).reduced()
        params = ptf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
        kw = pdata_lm.lm_batch_extras(cfg, gen, B, S)
        batch = {"tokens": tokens, "labels": tokens, **kw}
        torch.func.grad(lambda q: ptf.loss_fn(cfg, q, batch))(params)
        with pytest.raises(AssertionError, match="plain version ran"):
            ptf.prefill(cfg, params, tokens, capacity=S, **kw)
