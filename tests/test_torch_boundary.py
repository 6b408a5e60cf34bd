"""The port's boundaries: it imports neither jax nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              or isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"):
            names += [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_boundary_check_sees_forbidden_imports(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.configs import base\n"
                 "import repro_torch\nimportlib.import_module('jax')\n")
    assert [m.split(".")[0] in FORBIDDEN for m in _imported_modules(f)] == [True, True, False, True]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")


def test_engine_default_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import registry
    from repro_torch.serve import Engine

    cfg = registry.get("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Engine(cfg, {})


def test_api_default_device_raises_without_cuda(no_cuda):
    from repro_torch.configs import registry
    from repro_torch.models import api

    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_api(registry.get("qwen2-1.5b", smoke=True))
