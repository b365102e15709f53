"""Every module of the PyTorch port imports without JAX (and without
triton, which the machines without a GPU lack)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import pkgutil, sys
import mpas_ocean_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(mod.name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "triton"))
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
