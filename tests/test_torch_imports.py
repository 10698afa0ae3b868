"""The port stands alone: it imports neither ``jax`` nor ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                       r"|from\s+repro\.|from\s+repro\s+import)", re.M)


def test_port_imports_with_jax_blocked():
    """Every module of the port imports with ``jax`` and ``repro`` made
    unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('engine', 'step_fn', 'sampler', 'cache', 'faults',"
        " 'telemetry'):\n"
        "    assert 'repro_torch.serving.' + m in mods, mods\n"
        "for m in ('metrics', 'tree', 'scheduler'):\n"
        "    assert 'repro_torch.core.' + m in mods, mods\n"
        "for m in ('mamba', 'transformer', 'layers'):\n"
        "    assert 'repro_torch.models.' + m in mods, mods\n"
        "from repro_torch import configs\n"
        "for arch, m in configs._MODULES.items():\n"
        "    assert 'repro_torch.configs.' + m in mods, mods\n"
        "    assert configs.get_config(arch).name == arch\n"
        "assert 'repro_torch.configs.shapes' in mods, mods\n"
        "for m in ('data', 'optimizer', 'trainer', 'checkpoint'):\n"
        "    assert 'repro_torch.training.' + m in mods, mods\n"
        "assert 'repro_torch.launch.train' in mods, mods\n"
        "for m in ('mesh', 'launch', 'train_step'):\n"
        "    assert 'repro_torch.distributed.' + m in mods, mods\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k == 'repro'"
        " or k.startswith('repro.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_no_jax_or_repro_import_in_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_speculation_module_stands_alone():
    """``serving/speculation.py`` is the port's own copy of ``repro``'s
    framework-free module: it loads with ``torch``, ``jax`` and ``repro``
    all unimportable, and its proposer drafts."""
    path = PORT / "serving" / "speculation.py"
    code = (
        "import sys, importlib.util\n"
        "for m in ('torch', 'jax', 'repro', 'numpy'):\n"
        "    sys.modules[m] = None\n"
        f"s = importlib.util.spec_from_file_location('spec', {str(path)!r})\n"
        "mod = sys.modules['spec'] = importlib.util.module_from_spec(s)\n"
        "s.loader.exec_module(mod)\n"
        "p = mod.NGramProposer(mod.SpecConfig())\n"
        "print(p.propose([1, 2, 3, 1, 2, 3, 1, 2]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[[3, 1, 2]]"


LAUNCH = ("mesh", "sharding", "specs", "op_stats", "dryrun")
EXAMPLES = ("quickstart", "serve_docqa", "tree_speculation", "train_lm")


def test_launch_layer_and_examples_stand_alone():
    """The dry run's modules and the port's examples import neither
    ``jax`` nor ``repro`` and set no ``XLA_FLAGS``: the launch modules
    load with both made unimportable and leave the environment as it
    was."""
    files = [PORT / "launch" / f"{m}.py" for m in LAUNCH] + [
        ROOT / "examples" / "torch_port" / f"{m}.py" for m in EXAMPLES]
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.findall(text), f
        assert "XLA_FLAGS" not in text, f
    code = (
        "import os, sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "env = dict(os.environ)\n"
        f"for m in {LAUNCH!r}:\n"
        "    importlib.import_module('repro_torch.launch.' + m)\n"
        "assert dict(os.environ) == env\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or k == 'repro'"
        " or k.startswith('repro.') for k, v in sys.modules.items()"
        " if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


RANK_SIDE = ("torch_process_mesh_cases", "torch_process_train_cases")


def test_rank_side_helpers_import_no_jax():
    """The modules that spawned ranks import by name load with ``jax``
    and ``repro`` made unimportable."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {RANK_SIDE!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
