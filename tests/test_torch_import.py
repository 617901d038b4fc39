"""The port imports no JAX and nothing of the JAX package ``sivo_tpu``.

(a) A fresh interpreter imports every module of ``sivo_tpu_torch`` and
    ``chip_smoke.py``, then checks ``sys.modules``.
(b) An AST scan of the port's sources and ``chip_smoke.py`` finds no
    import statement of those packages, including imports inside
    functions, which (a) does not execute.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import sivo_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("sivo_tpu", "jax", "jaxlib", "flax")


def _port_modules() -> list[str]:
    return ["sivo_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(sivo_tpu_torch.__path__,
                                              "sivo_tpu_torch.")
    )


def _port_sources() -> list[Path]:
    return sorted((ROOT / "sivo_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_every_module_is_found():
    mods = _port_modules()
    for name in ("sivo_tpu_torch.config", "sivo_tpu_torch.io.synthetic",
                 "sivo_tpu_torch.runtime.tracking",
                 "sivo_tpu_torch.ops.kernel_match",
                 "sivo_tpu_torch.runtime.system",
                 "sivo_tpu_torch.runtime.mapping",
                 "sivo_tpu_torch.runtime.compact",
                 "sivo_tpu_torch.optim.local_ba",
                 "sivo_tpu_torch.ops.triangulation",
                 "sivo_tpu_torch.io.trajectory",
                 "sivo_tpu_torch.utils.profiling",
                 "sivo_tpu_torch.geometry.sim3",
                 "sivo_tpu_torch.optim.sim3_opt",
                 "sivo_tpu_torch.optim.pose_graph",
                 "sivo_tpu_torch.optim.ba_build",
                 "sivo_tpu_torch.optim.gba_cg",
                 "sivo_tpu_torch.place.vocabulary",
                 "sivo_tpu_torch.place.database",
                 "sivo_tpu_torch.runtime.loopclosing",
                 "sivo_tpu_torch.cli",
                 "sivo_tpu_torch.models.caffe_io",
                 "sivo_tpu_torch.io.kitti",
                 "sivo_tpu_torch.io.serialization",
                 "sivo_tpu_torch.viz.replay",
                 "sivo_tpu_torch.native",
                 "sivo_tpu_torch.models.train",
                 "sivo_tpu_torch.tools.train_bench_segnet",
                 "sivo_tpu_torch.tools.train_offline_vocab",
                 "sivo_tpu_torch.parallel",
                 "sivo_tpu_torch.parallel.multi_sequence",
                 "sivo_tpu_torch.parallel.sharded_ba",
                 "sivo_tpu_torch.parallel.ranks",
                 "sivo_tpu_torch.entry"):
        assert name in mods
    assert len(_port_sources()) > len(mods)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_sivo_tpu(path):
    bad = _imported_roots(ast.parse(path.read_text())) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_catches_a_forbidden_import():
    src = "def f():\n    from sivo_tpu.config import SystemConfig\n"
    assert "sivo_tpu" in _imported_roots(ast.parse(src))
    assert "jax" in _imported_roots(ast.parse("import jax.numpy as jnp"))
