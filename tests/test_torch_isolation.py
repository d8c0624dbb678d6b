"""The port stands alone: importing ``repro_torch`` and every one of its
modules loads neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1]) / "repro_torch"
names = []
for path in sorted(root.rglob("*.py")):
    parts = path.relative_to(root.parent).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    names.append(".".join(parts))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
subs = sorted({n.split(".")[1] for n in names if "." in n})
print(len(names), ",".join(subs), ",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(SRC)], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 70                 # every module was imported
    assert {"optim", "data", "models", "configs", "launch", "core", "ops",
            "kernels", "stream", "runtime", "obs"} <= set(out[1].split(","))
    assert out[2:] == [], f"the port imported {out[2:]}"
