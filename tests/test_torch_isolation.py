"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, use no library attention or
``torch.compile`` in place of a kernel, and never fall back to the CPU on
their own.

One function is exempt from the library-attention rule: the smoke run's
yardstick ``chip_smoke.library_attention_ms``, which times
``scaled_dot_product_attention`` beside the flash kernel for the kernels
line's ``library_ms``. A test pins that it is called only by the smoke
run's kernel check and that no serving path can reach it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# library calls that would stand in for a hand-written kernel
FORBIDDEN_ATTRS = {"scaled_dot_product_attention", "flash_attention",
                   "flex_attention"}
# the one function allowed to call a library attention: chip_smoke.py's
# timing of the library yardstick, which the port never calls
SMOKE = ROOT / "chip_smoke.py"
YARDSTICK = ("library_attention_ms", "scaled_dot_product_attention")


def top_level_functions(path: Path) -> dict[str, ast.FunctionDef]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def callers(path: Path, name: str) -> set[str]:
    """Top-level functions of ``path`` whose bodies call ``name``."""
    return {fn for fn, node in top_level_functions(path).items()
            for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name) and c.func.id == name}


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference_package():
    assert len(PORT_FILES) > 10
    bad = [(p.relative_to(ROOT), m) for p in PORT_FILES
           for m in imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_port_calls_no_library_attention_or_compile():
    fn, attr = YARDSTICK
    exempt = {(n.lineno, n.col_offset)
              for n in ast.walk(top_level_functions(SMOKE)[fn])
              if isinstance(n, ast.Attribute) and n.attr == attr}
    assert len(exempt) == 1
    bad = []
    for p in PORT_FILES:
        for node in ast.walk(ast.parse(p.read_text())):
            if not isinstance(node, ast.Attribute) or (
                    p == SMOKE and (node.lineno, node.col_offset) in exempt):
                continue
            torch_compile = node.attr == "compile" and isinstance(
                node.value, ast.Name) and node.value.id == "torch"
            if node.attr in FORBIDDEN_ATTRS or torch_compile:
                bad.append((p.relative_to(ROOT), node.lineno, node.attr))
    assert bad == []


def test_library_yardstick_is_reached_from_no_serving_path():
    """The exempt timing function is named by no module of the port, is
    called only by the smoke run's flash-kernel check, and that check only
    by ``main``: none of the serving, replay or profiling phases reaches
    it."""
    fn, _ = YARDSTICK
    assert not [p for p in PORT_FILES
                if p != SMOKE and fn in p.read_text()]
    assert callers(SMOKE, fn) == {"check_flash_kernel"}
    assert callers(SMOKE, "check_flash_kernel") == {"main"}


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k == 'repro' or k.startswith('repro.')\n"
        "               for k in sys.modules), 'repro imported'\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("arch,mode", [("smollm-360m", "paged"),
                                       ("smollm-360m", "continuous"),
                                       ("recurrentgemma-2b", "continuous"),
                                       ("rwkv6-1.6b", "continuous")])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                           arch, mode):
    from repro_torch.configs import get
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve import ServeEngine
    from repro_torch.weights import params_from_jax

    cfg = get(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params, mode=mode)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"embed": {}, "final_norm": {}, "layers": {}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"embed": {}, "final_norm": {}, "blocks": {},
                         "rem": []})
    eng = ServeEngine(cfg, params, mode=mode, device="cpu")
    assert eng.device.type == "cpu" and eng.mode == mode


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
