"""The port stands alone: no module of ``repro_torch`` (the checkpoint,
fault and ``tune/`` modules included), and not ``chip_smoke.py``, imports
``jax`` or the reference package ``repro``, and neither does a rank that
``launch/train.py`` spawns (a fresh interpreter), also when it saves and
resumes a checkpoint or runs the self-tuning controller;
entry points asked for the card raise without one instead of running on
the CPU; ``chip_smoke.py`` fails without a card and outside the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    bad = [m for m in _imports(path)
           if m and m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k == 'repro'"
        " or k.startswith('repro.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(mods))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 16


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.models.params import from_jax_params
    cfg = configs.get("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "gemma3-1b", "--reduced"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "gemma3-1b", "--reduced", "--dp", "2"])


def test_spawned_ranks_import_no_reference():
    from repro_torch.launch.train import spawn_world
    res = spawn_world("repro_torch.launch.train:train_rank", 2,
                      dict(arch="gemma3-1b", reduced=True, dp=2, tp=1,
                           steps=1, seq=8, global_batch=2, device="cpu"),
                      timeout=300)
    assert [r["foreign_modules"] for r in res] == [[], []]


def test_checkpoint_modules_are_covered(tmp_path):
    """The checkpoint and fault modules are in the scan above, and ranks
    that save and then resume import neither jax nor repro."""
    names = {p.relative_to(PKG).as_posix() for p in FILES if PKG in p.parents}
    assert {"train/checkpoint.py", "train/fault.py"} <= names
    from repro_torch.launch.train import spawn_world
    kw = dict(arch="gemma3-1b", reduced=True, dp=2, tp=1, steps=1, seq=8,
              global_batch=2, device="cpu", ckpt_dir=str(tmp_path))
    for resume in (False, True):
        res = spawn_world("repro_torch.launch.train:train_rank", 2,
                          dict(kw, resume=resume), timeout=300)
        assert [r["foreign_modules"] for r in res] == [[], []]
        assert res[0]["start"] == (1 if resume else 0)


def test_tune_modules_are_covered(tmp_path):
    """The tune package is in the scan above, and tuned ranks (the tunable
    sites, the controller, the artifact, the tune state's checkpoint and a
    ``--policy-from`` replay) import neither jax nor repro."""
    names = {p.relative_to(PKG).as_posix() for p in FILES if PKG in p.parents}
    assert {"tune/__init__.py", "tune/ladder.py", "tune/tracker.py",
            "tune/controller.py", "tune/policy_artifact.py"} <= names
    from repro_torch.launch.train import spawn_world
    kw = dict(arch="gemma3-1b", reduced=True, dp=2, tp=1, steps=2, seq=8,
              global_batch=2, device="cpu", ckpt_dir=str(tmp_path),
              scheme="zhybrid_16_8")
    res = spawn_world("repro_torch.launch.train:train_rank", 2,
                      dict(kw, tune=True, tune_interval=1), timeout=300)
    assert [r["foreign_modules"] for r in res] == [[], []]
    assert [len(r["tune"]["rounds"]) for r in res] == [2, 2]
    res = spawn_world("repro_torch.launch.train:train_rank", 2,
                      dict(kw, steps=1, ckpt_dir="", policy_from=str(
                          tmp_path / "tune_policy.json")), timeout=300)
    assert [r["foreign_modules"] for r in res] == [[], []]


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
