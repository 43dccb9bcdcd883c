"""No module that a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``multithreading_string_matching_tpu`` (names compare whole:
the program's own name begins with the last), and the reference loads
nothing of the program either."""

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


def test_reference_loads_nothing_of_the_program():
    got = python(
        "import json, sys\n"
        "from gpubench.gen.synth import synth_udp_pcap\n"
        "from gpubench.reference import capture_counts\n"
        "import tempfile, os\n"
        "d = tempfile.mkdtemp(); p = os.path.join(d, 'c.pcap')\n"
        "synth_udp_pcap(p, 50, payload_len=64, patterns=[b'ab'], plant_rate=0.5, seed=1)\n"
        "c, n = capture_counts(p, [b'ab'])\n"
        "os.remove(p); os.rmdir(d)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not set(got) & (FORBIDDEN | {PROGRAM})


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
