"""The PyTorch port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_with_jax_blocked():
    """Each module imports in a fresh interpreter where ``import jax`` fails."""
    mods = port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.serving.engine",
            "repro_torch.bridge", "repro_torch.core.hpa", "repro_torch.serving.elastic",
            "repro_torch.serving.prefix_cache", "repro_torch.launch.serve",
            "repro_torch.kernels.page_copy", "repro_torch.kernels.flash_attention",
            "repro_torch.serving.adapters", "repro_torch.kernels.soft_threshold",
            "repro_torch.core.rsvd", "repro_torch.core.salaad", "repro_torch.core.prox",
            "repro_torch.models.flash_vjp", "repro_torch.optim.adam",
            "repro_torch.optim.schedule", "repro_torch.data.synthetic",
            "repro_torch.train.state", "repro_torch.train.steps",
            "repro_torch.train.checkpoint", "repro_torch.train.fault",
            "repro_torch.train.trainer", "repro_torch.launch.train",
            "repro_torch.models.ssm", "repro_torch.models.hybrid",
            "repro_torch.configs.zamba2_2p7b", "repro_torch.serving.telemetry",
            "repro_torch.serving.trace"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        bad = imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
