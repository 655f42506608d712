"""repro_torch and chip_smoke.py stand alone: they import no jax and
nothing of the reference package, and chip_smoke.py refuses to report a
result without a GPU or outside a checkout."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, SRC
from torch_train_common import on_one_thread  # noqa: F401 (autouse: one torch thread)

PKG = pathlib.Path(SRC) / "repro_torch"
SMOKE = pathlib.Path(REPO) / "chip_smoke.py"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)


def _modules():
    return sorted(
        ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
        if "build" not in p.relative_to(PKG).parts[:-1]
    )


def test_sources_import_no_jax_and_no_reference():
    files = [p for p in PKG.rglob("*.py") if "build" not in p.relative_to(PKG).parts[:-1]] + [SMOKE]
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        assert not FORBIDDEN.search(text), f"{path} imports jax or the reference package"
        assert "import jax" not in text


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {SRC!r}); sys.path.insert(0, {REPO!r})\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('IMPORTED', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "IMPORTED" in out.stdout


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=env)


def test_chip_smoke_fails_without_a_gpu_or_a_checkout(tmp_path):
    import torch

    if not torch.cuda.is_available():
        out = _run_smoke(REPO, SMOKE)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    out = _run_smoke(tmp_path, alone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_new_modules_are_covered():
    """The r2c transforms, the apps, the process-group mesh, the fault
    layer, the checkpoints and the serving engine are among the modules
    the two checks above import with jax blocked."""
    mods = _modules()
    for m in ("repro_torch.core.real", "repro_torch.core.mesh", "repro_torch.apps",
              "repro_torch.apps.spectral", "repro_torch.apps.poisson", "repro_torch.apps.derivatives",
              "repro_torch.apps.convolve", "repro_torch.runtime", "repro_torch.runtime.faults",
              "repro_torch.runtime.monitor", "repro_torch.runtime.elastic", "repro_torch.checkpoint",
              "repro_torch.checkpoint.manager", "repro_torch.serve", "repro_torch.serve.queue",
              "repro_torch.serve.spectral"):
        assert m in mods, m
    assert "class ProcessGroupMesh" in (PKG / "core" / "mesh.py").read_text()


def test_new_entry_points_ask_for_the_card(tmp_path):
    """Called without device=, the process-group entry point, the plans
    the apps run on, elastic_mesh and the serving engine pick the card,
    and raise without one."""
    import torch

    from repro_torch.core import SimMesh, init_process_mesh
    from repro_torch.runtime import elastic_mesh
    from repro_torch.serve import SpectralEngine

    if torch.cuda.is_available():
        assert SimMesh(2).device.type == "cuda"
        assert elastic_mesh().device.type == "cuda"
        assert SpectralEngine(SimMesh(2)).pool.mesh.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        elastic_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpectralEngine(SimMesh(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_process_mesh(0, 1, f"file://{tmp_path / 'rendezvous'}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_process_mesh(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    import torch.distributed as dist

    assert not dist.is_initialized()
