"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor anything of the JAX package ``repro``."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import repro_torch, repro_torch.serving, repro_torch.launch.serve, repro_torch.bridge
import repro_torch.core, repro_torch.kernels.dispatch
import repro_torch.optim, repro_torch.data, repro_torch.runtime.train, repro_torch.launch.train
import repro_torch.dist.collectives, repro_torch.core.staged
import repro_torch.checkpoint, repro_torch.serving.spec, repro_torch.serving.loadgen
import repro_torch.core.comm, repro_torch.dist, repro_torch.dist.fault
import repro_torch.launch.rendezvous
bad = sorted(
    name for name, mod in sys.modules.items()
    if mod is not None and (name == "repro" or name.startswith(("repro.", "jax")))
)
print("LOADED", bad)
"""


def test_import_without_jax_loads_no_repro_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True, env=env, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)", re.MULTILINE)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_imports_no_jax_or_repro(path):
    hits = _FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, f"{path}: {hits}"
