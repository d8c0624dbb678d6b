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
new = [n for n in ("repro_torch.models.recurrence", "repro_torch.models.ssm",
                   "repro_torch.models.xlstm", "repro_torch.models.moe",
                   "repro_torch.launch.serve") if n in names]
print(len(names), ",".join(subs), len(new), ",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(SRC)], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert int(out[0]) >= 75                 # every module was imported
    assert {"optim", "data", "models", "configs", "launch", "core", "ops",
            "kernels", "stream", "runtime", "obs"} <= set(out[1].split(","))
    assert out[2] == "5"          # the MoE, SSM, xLSTM, scan and serving
    assert out[3:] == [], f"the port imported {out[3:]}"


_BLOCKED = r"""
import importlib, sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
for name in ("repro_torch.launch.specs", "repro_torch.models.tp",
             "repro_torch.launch.mesh", "repro_torch.launch.shardings",
             "repro_torch.launch.train", "repro_torch.launch.serve"):
    importlib.import_module(name)
print("ok")
"""


def test_tensor_parallel_modules_import_with_jax_and_repro_blocked():
    """The model axis, the specs and both entry points import with every
    import of ``jax``, ``jaxlib`` and ``repro`` made to fail."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["ok"]


_DRYRUN = r"""
import importlib, os, sys


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())
env = dict(os.environ)
import torch.distributed as dist
for name in ("repro_torch.launch.dryrun", "repro_torch.obs.repeat"):
    importlib.import_module(name)
print(dist.is_initialized(), dict(os.environ) == env)
"""


def test_dry_run_imports_with_jax_blocked_and_starts_nothing():
    """The dry run imports with ``jax``, ``jaxlib`` and ``repro`` blocked;
    importing it starts no process group and sets no environment
    variable (the JAX package's sets ``XLA_FLAGS``)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _DRYRUN], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "True"]
