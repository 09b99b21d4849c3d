"""The port's boundary: it imports neither ``jax`` nor any ``repro``
module, its entry points refuse to fall back to the CPU quietly, and
``chip_smoke.py`` prints no result without a GPU or outside a checkout."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.config.arch import reduced_for_smoke
from repro_torch.configs import get_arch
from repro_torch.core.hcache import HCacheManager
from repro_torch.models import Model
from repro_torch.storage import ChunkStore, make_array

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any import of jax now fails
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(n for n in sys.modules
                if n == "repro" or n.startswith("repro.")
                or n == "jax" and sys.modules[n] is not None)
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.split(" ", 1)
    assert int(n) >= 25 and leaked.strip() == "[]"


BANNED = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                    r"from\s+(jax|repro)\b(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert not BANNED.findall(path.read_text())


def test_entry_points_refuse_the_cpu_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_for_smoke(get_arch("llama2-7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HCacheManager(Model(cfg), ChunkStore(make_array("dram", 1)))
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    """No CUDA here: the script exits non-zero and prints no result; a
    directory holding only the script fails the same way."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
