"""The port imports nothing of JAX or of the JAX package, at any depth.

``test_port_imports_no_jax`` (test_torch_port_primitives.py) checks which
modules an import loads; an import inside a function slips past it. This
test reads the source instead: every ``.py`` file of
``pyramid_flow_tpu_torch/`` and the port's scripts, parsed with ``ast``,
must hold no ``import``/``from`` of ``jax``, ``flax`` or
``pyramid_flow_tpu`` (``pyramid_flow_tpu_torch`` is the port itself),
wherever the statement stands.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "pyramid_flow_tpu")
SOURCES = sorted((ROOT / "pyramid_flow_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "time_kernels.py",
    ROOT / "profile_unit.py"]


def forbidden_imports(source: str):
    """(line, module) of every absolute import of a forbidden top-level
    package in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n.split(".")[0] in FORBIDDEN]
    return found


def test_checker_finds_imports_at_any_depth():
    src = ("import os\nfrom . import model\nfrom ..data import bucket\n"
           "import pyramid_flow_tpu_torch.ops\n"
           "def f():\n    if True:\n"
           "        from pyramid_flow_tpu.data import x\n"
           "class C:\n    def g(self):\n"
           "        import jax.numpy as jnp, flax\n")
    assert forbidden_imports(src) == [(7, "pyramid_flow_tpu.data"),
                                      (10, "jax.numpy"), (10, "flax")]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_port_source_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []


# the modules of the last slice: the planner, profiling, the 768p tools,
# the schedulers' registry and the resamplers
SLICE_MODULES = (
    "pyramid_flow_tpu_torch.utils.profiling",
    "pyramid_flow_tpu_torch.schedulers",
    "pyramid_flow_tpu_torch.schedulers.cosine_ddpm",
    "pyramid_flow_tpu_torch.ops.resample",
    "pyramid_flow_tpu_torch.models.vae.blocks",
    "pyramid_flow_tpu_torch.pipeline.pyramid_pipeline",
    "pyramid_flow_tpu_torch.tools.profile_768p",
    "pyramid_flow_tpu_torch.tools.exp_vae_tiling",
    "pyramid_flow_tpu_torch.tools.exp_conv_stack",
    "pyramid_flow_tpu_torch.tools.exp_decode_scan",
)


def test_slice_modules_import_without_jax():
    """Importing each of the slice's modules loads no JAX and builds no
    kernel (no card here)."""
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'pyramid_flow_tpu')"
            " or m.startswith(('jax.', 'flax', 'pyramid_flow_tpu.'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr
    for m in SLICE_MODULES:
        path = ROOT / (m.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / m.replace(".", "/") / "__init__.py"
        assert path in SOURCES, m
