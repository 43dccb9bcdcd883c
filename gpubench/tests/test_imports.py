"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``multithreading_string_matching_tpu`` (names compare whole:
the program's own name begins with the last), and no reference or
generator loads anything of the program either."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "gpubench"
FORBIDDEN = {"jax", "jaxlib", "flax", "multithreading_string_matching_tpu"}
PROGRAM = "multithreading_string_matching_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def python(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_yardstick_sources_import_nothing_of_the_program():
    for sub in ("reference", "gen", "metrics"):
        for path in (BENCH_DIR / sub).rglob("*.py"):
            assert PROGRAM not in imported_tops(path), path
    for name in ("trace.py", "roofline.py", "registry.py", "run.py"):
        assert PROGRAM not in imported_tops(BENCH_DIR / name)


def test_references_and_generators_load_nothing_of_the_program():
    """Every module under ``reference/`` and ``gen/`` imported, and each
    cell's generator and reference, found by name, run on a small capture."""
    got = python(
        "import importlib, json, pathlib, sys, tempfile\n"
        "from gpubench import registry\n"
        "from gpubench.gen.inputs import make_inputs\n"
        "root = registry.BENCH_DIR.parent\n"
        "for sub in ('reference', 'gen'):\n"
        "    for f in sorted((registry.BENCH_DIR / sub).glob('*.py')):\n"
        "        importlib.import_module('gpubench.' + sub + ('' if f.stem == '__init__' else '.' + f.stem))\n"
        "bench = registry.load_benchmark(root)\n"
        "ran = []\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    for k, w in enumerate(bench['workloads']):\n"
        "        cfg = registry.config(bench, w['config'], root)\n"
        "        mix = registry.traffic(w['traffic'])\n"
        "        mix['capture'].update(packets=50)\n"
        "        work = pathlib.Path(d) / str(k)\n"
        "        work.mkdir()\n"
        "        inputs = make_inputs(cfg, mix, 1, root, work)\n"
        "        ref = registry.reference(cfg.get('reference', registry.DEFAULT_REFERENCE))\n"
        "        counts, n = ref.capture_counts(inputs.captures[0], inputs.patterns, inputs.mode, 'cpu')\n"
        "        ran.append(n == inputs.payload_bytes[0])\n"
        "print(json.dumps({'ran': ran,\n"
        "                  'tops': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    assert got["ran"] and all(got["ran"])
    assert not set(got["tops"]) & (FORBIDDEN | {PROGRAM})


@pytest.mark.parametrize("workload,over", [
    ("ref_strings.stream_mega", {"packets": 300}),
])
@pytest.mark.parametrize("traced", [False, True])
def test_a_run_loads_no_jax(workload, over, traced):
    got = python(
        "import json, sys\n"
        "from gpubench import run\n"
        f"res, _ = run.run_cell({workload!r}, 9, 0.2, {traced}, device='cpu', "
        f"capture_overrides={over!r})\n"
        "print(json.dumps({'correct': res['correct'], 'forbidden': run.forbidden_modules(),\n"
        f"  'program': {PROGRAM!r} in sys.modules}}))\n")
    assert got == {"correct": True, "forbidden": [], "program": True}
