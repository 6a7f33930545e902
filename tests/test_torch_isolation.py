"""The PyTorch port stands alone: it imports no JAX, networkx or ``repro``,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "networkx", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "importorskip") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax_networkx_or_repro(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_a_silent_cpu_run(monkeypatch):
    from repro_torch.core import gp, network

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        network.table_ii_instance("abilene")
    inst = network.table_ii_instance("abilene", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gp.solve(inst, max_iters=1)
    assert gp.solve(inst, max_iters=1, device="cpu").iterations == 1
