"""The import guard: nothing ``perfbench/run.py`` loads has the top-level
name ``jax`` or ``repro`` (compared whole: ``repro_torch`` is the port),
and the reference loads none of ``jax``, ``repro`` or ``repro_torch``."""

import re
import subprocess
import sys

from perfbench import spec

ROOT = spec.ROOT
IMPORT = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][\w]*)", re.M)


def top_level_imports(path):
    return set(IMPORT.findall(path.read_text()))


def test_sources_import_neither_jax_nor_repro():
    files = sorted(spec.HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        names = top_level_imports(f)
        assert not names & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.parts:
            assert not names & {"repro_torch", "perfbench"}, f


def _run(code):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_a_run_loads_no_jax_nor_repro():
    """A whole CPU run, with ``jax`` and ``repro`` made unimportable, and
    run.py's own look at ``sys.modules`` afterwards."""
    out = _run(
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "sys.path[0:0] = ['src', '.', 'perfbench/tests']\n"
        "import perfbench_smoke as smoke\n"
        "from perfbench import run\n"
        "res = smoke.run(smoke.cell('qwen3-4b.docqa'), seconds=1.0)\n"
        "assert res['correct'], res\n"
        "for m in ('jax', 'jaxlib', 'flax', 'repro'):\n"
        "    del sys.modules[m]\n"
        "print(run.forbidden_modules())\n"
        "assert 'repro_torch' in sys.modules\n")
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    out = _run(
        "import sys, types\n"
        "sys.path[0:0] = ['src', '.']\n"
        "from perfbench import run\n"
        "import repro_torch\n"
        "assert run.forbidden_modules() == []\n"
        "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
        "print(run.forbidden_modules())\n")
    assert out.strip() == "['repro']"


def test_reference_loads_without_the_program():
    _run(
        "import sys\n"
        "for m in ('jax', 'repro', 'repro_torch', 'perfbench'):\n"
        "    sys.modules[m] = None\n"
        "import importlib.util, torch\n"
        "s = importlib.util.spec_from_file_location("
        "'ref', 'perfbench/reference/dense.py')\n"
        "mod = importlib.util.module_from_spec(s)\n"
        "s.loader.exec_module(mod)\n"
        "cfg = dict(hidden_size=8, num_attention_heads=2,"
        " num_key_value_heads=1, head_dim=4, intermediate_size=12,"
        " rms_norm_eps=1e-6, rope_theta=1e4, num_hidden_layers=1,"
        " tie_word_embeddings=True)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "w = {'embed': torch.randn(11, 8, generator=g),"
        " 'final_norm.scale': torch.ones(8),"
        " 'layers.0.ln.scale': torch.ones(8),"
        " 'layers.0.ln2.scale': torch.ones(8),"
        " 'layers.0.attn.wq.w': torch.randn(8, 8, generator=g),"
        " 'layers.0.attn.wk.w': torch.randn(8, 4, generator=g),"
        " 'layers.0.attn.wv.w': torch.randn(8, 4, generator=g),"
        " 'layers.0.attn.wo.w': torch.randn(8, 8, generator=g),"
        " 'layers.0.ffn.wi.w': torch.randn(8, 24, generator=g),"
        " 'layers.0.ffn.wo.w': torch.randn(12, 8, generator=g)}\n"
        "out = mod.Dense(cfg, w).logits([1, 2], [[3, 4, 5]], [0])\n"
        "assert out[0].shape == (3, 11)\n"
        "assert not any(k.split('.')[0] in ('jax', 'repro', 'repro_torch')"
        " for k, v in sys.modules.items() if v is not None)\n")
