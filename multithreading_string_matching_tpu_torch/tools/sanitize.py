"""compute-sanitizer over every hand-written kernel of the port.

    python -m multithreading_string_matching_tpu_torch.tools.sanitize
        [--cases N] [--seed K] [--targets A,B,...]

Equality with the plain versions cannot see a race that did not fire, an
out-of-bounds read that returned zeros or a barrier that one branch skips.
For each tool this runs, in a child process with a time limit::

    compute-sanitizer --tool T --error-exitcode 1 --kernel-name kns=<kernel> ...
        python -m multithreading_string_matching_tpu_torch.tools.differential
        --cases N --seed K

so each of the 12 kernel entry points gets at least ``N`` random cases
(``tools/differential.py``, its launch counters and its comparisons with
the plain versions included).  The child runs with
``PYTORCH_NO_CUDA_MEMORY_CACHING=1``: with PyTorch's caching allocator a
read past one tensor lands inside the allocator's segment, where memcheck
sees nothing.  The kernel filter names the port's six kernels
(:data:`KERNELS`): PyTorch's own kernels inside the plain versions would
dominate the time, and their reports are not the port's.

Each tool gives one record: the card's name and power limit, the cases per
entry point, the errors (``ERROR SUMMARY``; racecheck's hazards, errors and
warnings, a warning counting as not clean), the seconds, a status
(``clean``, ``errors``, ``failed``: no summary, the differential did not
finish clean or the time ran out; or ``not available`` with the reason)
and what the tool cannot see (:data:`BLIND_SPOTS`), which is never a pass.
Before the tools, a probe runs the sanitizer over one small CUDA program:
if the sanitizer is missing or refuses the card ("Device not supported"),
every record says ``not available`` and nothing counts as clean.  The
self-test (memcheck over one launch of ``msm_window_count_totals``
through the raw C entry, with a payload half the ``n x L`` it claims) must
be reported: it proves that the filter reaches the kernels.

Exit code: 0 when every tool ran clean and the self-test was reported; 1
on any error, failure or unreported self-test; 2 when the sanitizer is not
available (nothing was checked).  Without a card it exits non-zero.  The
tool is found like the compiler (``ops/_build.find_nvcc``): next to
``nvcc``, in ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, on the PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# The port's kernels (csrc/), by the names in their mangled symbols.
KERNELS = ("probe_count_kernel", "window_find_kernel", "mxu_wgmma_kernel", "ac_scan_kernel",
           "kmp_group_kernel", "kmp_wide_kernel")
DEFAULT_CASES = 8
DEFAULT_TIMEOUT_S = 1800
PROBE_TIMEOUT_S = 120

# What each tool cannot see in these kernels: printed with every record,
# never counted as checked.
BLIND_SPOTS = {
    "memcheck": [
        "reads and writes that stay inside another live allocation (the child "
        "turns PyTorch's caching allocator off, but cudaMalloc's own sub-allocation "
        "of small buffers remains)",
        "the values read: a read of the wrong in-bounds byte is a plain-version divergence",
    ],
    "racecheck": [
        "global memory: window_find's decoupled look-back flags (csrc/window_find.cu:131-140, "
        "relaxed 64-bit words) and every kernel's atomics on global outputs",
        "shared memory filled by TMA bulk copies on an mbarrier (window_find.cu:118-130, "
        ":165-175) and read by wgmma's async proxy (mxu_count.cu:357), where the tool "
        "does not model the async proxy",
        "hazards that a tested schedule did not reach",
    ],
    "synccheck": [
        "races with correct barriers; only barrier misuse (divergent __syncthreads, "
        "bar.sync counts, mbarrier use) is reported",
    ],
    "initcheck": [
        "shared memory; only reads of uninitialised global memory are reported",
        "outputs the wrapper zeroes before the launch (torch.zeros), whose stale "
        "values would be initialised",
    ],
}

_ERRORS = re.compile(r"ERROR SUMMARY: (\d+) errors?")
_RACES = re.compile(r"RACECHECK SUMMARY: (\d+) hazards? displayed \((\d+) errors?, (\d+) warnings?\)")
_CLEAN = re.compile(r"differential clean: (\d+) cases")
# The sanitizer's own refusal, on a line of its prefix (not the target's).
_UNSUPPORTED = re.compile(r"(?m)^=+ Error: (Device not supported[^\n]*)")


def find_sanitizer() -> Optional[str]:
    """``compute-sanitizer`` next to ``nvcc``, in ``$CUDA_HOME/bin``,
    ``/usr/local/cuda/bin`` (or its ``compute-sanitizer/`` folder) or on the
    PATH; ``None`` when there is none."""
    from multithreading_string_matching_tpu_torch.ops._build import find_nvcc

    cands = []
    try:
        cands.append(pathlib.Path(find_nvcc()).parent / "compute-sanitizer")
    except RuntimeError:
        pass
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "compute-sanitizer")
    cands += [pathlib.Path("/usr/local/cuda/bin/compute-sanitizer"),
              pathlib.Path("/usr/local/cuda/compute-sanitizer/compute-sanitizer")]
    for c in cands:
        if c.exists():
            return str(c)
    return shutil.which("compute-sanitizer")


def child_env() -> Dict[str, str]:
    """The child's environment: PyTorch's caching allocator off, and the
    checkout on the import path."""
    from multithreading_string_matching_tpu_torch.ops._build import PKG_DIR

    env = dict(os.environ)
    env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(PKG_DIR.parent),
                                                      env.get("PYTHONPATH")]))
    return env


def sanitizer_command(sanitizer: str, tool: str, program: List[str]) -> List[str]:
    """``compute-sanitizer --tool T --error-exitcode 1`` restricted to
    :data:`KERNELS`, in front of ``program``."""
    cmd = [sanitizer, "--tool", tool, "--error-exitcode", "1", "--print-limit", "50"]
    for k in KERNELS:
        cmd += ["--kernel-name", f"kns={k}"]
    return cmd + program


def differential_command(cases: int, seed: int, out: str, targets: Optional[str] = None
                         ) -> List[str]:
    cmd = [sys.executable, "-m", "multithreading_string_matching_tpu_torch.tools.differential",
           "--cases", str(cases), "--seed", str(seed), "--out", out]
    return cmd + (["--targets", targets] if targets else [])


def parse_output(text: str, rc: Optional[int], tool: str) -> dict:
    """The counts and the status of one sanitizer run from its output and
    exit code (``None``: the time ran out)."""
    rec: Dict[str, object] = {"errors": None, "hazards": None, "warnings": None}
    unsupported = _UNSUPPORTED.search(text)
    if unsupported:
        rec["status"] = f"not available: {unsupported[1].strip()}"
        return rec
    found = _RACES.search(text) if tool == "racecheck" else None
    if found:
        rec.update(hazards=int(found[1]), errors=int(found[2]), warnings=int(found[3]))
    else:
        found = _ERRORS.search(text)
        if found:
            rec["errors"] = int(found[1])
    clean = _CLEAN.search(text)
    rec["cases"] = int(clean[1]) if clean else None
    if rec["errors"] or rec["warnings"]:
        rec["status"] = "errors"
    elif rc is None:
        rec["status"] = "failed: timed out"
    elif rec["errors"] is None:
        rec["status"] = f"failed: no {tool} summary (exit code {rc})"
    elif rc != 0 or not clean:
        rec["status"] = f"failed: exit code {rc}, differential {'clean' if clean else 'not clean'}"
    else:
        rec["status"] = "clean"
    return rec


def run_child(cmd: List[str], timeout: float):
    """``(rc or None on timeout, combined output, seconds)`` of ``cmd``.  The
    child leads a process group of its own, killed whole at ``timeout``
    (the sanitizer's target process included)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=child_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        rc = None
    return rc, text, time.perf_counter() - t0


PROBE_PROGRAM = [sys.executable, "-c",
                 "import torch; x = torch.ones(64, device='cuda'); "
                 "assert int((x + 1).sum()) == 128; torch.cuda.synchronize()"]
OVERRUN_PROGRAM = [sys.executable, "-m", "multithreading_string_matching_tpu_torch.tools.sanitize",
                   "--overrun"]


def probe(sanitizer: Optional[str]) -> Optional[str]:
    """``None`` when the sanitizer can run a small CUDA program on the card,
    else why not."""
    if sanitizer is None:
        return "compute-sanitizer not found"
    rc, text, _ = run_child([sanitizer, "--tool", "memcheck", "--error-exitcode", "1",
                             *PROBE_PROGRAM], PROBE_TIMEOUT_S)
    unsupported = _UNSUPPORTED.search(text)
    if unsupported:
        return unsupported[1].strip()
    if rc != 0:
        tail = " | ".join(text.strip().splitlines()[-3:])
        return f"memcheck over a small CUDA program exits {rc}: {tail[:300]}"
    return None


def overrun() -> None:
    """One launch of ``msm_window_count_totals`` through the raw C entry,
    told that an 8 x 256 payload (2 KB) is 16 x 256: the kernel reads 2 KB
    past the allocation (inside the same page, so nothing faults without a
    checker)."""
    import torch

    from multithreading_string_matching_tpu_torch.ops import cuda_window as cw
    from multithreading_string_matching_tpu_torch.ops.window import WindowProgram

    dev = torch.device("cuda", 0)
    words, masks, lens = WindowProgram.build([b"ab", b"abc"]).tables(dev)
    payload = torch.full((8, 256), ord("a"), dtype=torch.uint8, device=dev)
    lengths = torch.full((16,), 256, dtype=torch.int32, device=dev)
    out = torch.zeros(words.shape[0], dtype=torch.int32, device=dev)
    cw.LIBRARY.call("msm_window_count_totals", payload.data_ptr(), lengths.data_ptr(),
                    words.data_ptr(), masks.data_ptr(), lens.data_ptr(), out.data_ptr(),
                    16, 256, words.shape[0], words.shape[1], 1, 0,
                    torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    print(f"overrun launched: {out.tolist()}")


def audit(cases: int = DEFAULT_CASES, seed: int = 0, targets: Optional[str] = None,
          timeout: float = DEFAULT_TIMEOUT_S, log=print) -> List[dict]:
    """One record per tool and one for the self-test (see the module's
    docstring); each child may take ``timeout`` seconds."""
    from multithreading_string_matching_tpu_torch.utils.timing import card_line

    card = {"card": card_line()}
    sanitizer = find_sanitizer()
    reason = probe(sanitizer)
    records = []
    out = tempfile.mkdtemp(prefix="msm_sanitize_")
    for tool in TOOLS:
        rec = {"tool": tool, "cases_per_entry": cases, "seed": seed, "targets": targets or "all",
               "kernels": list(KERNELS), **card}
        if reason is not None:
            rec.update(status=f"not available: {reason}", errors=None, hazards=None,
                       warnings=None, cases=None, seconds=0.0)
        else:
            cmd = sanitizer_command(sanitizer, tool, differential_command(cases, seed, out,
                                                                          targets))
            rc, text, secs = run_child(cmd, timeout)
            rec.update(parse_output(text, rc, tool), seconds=round(secs, 3))
        rec["blind_spots"] = BLIND_SPOTS[tool]
        records.append(rec)
        log(f"sanitize {tool}: {rec['status']}, errors {rec['errors']}, hazards "
            f"{rec['hazards']}, warnings {rec['warnings']}, {rec['cases']} cases "
            f"({cases} an entry point), {rec['seconds']} s [{card['card']}]")
    rec = {"tool": "self-test (memcheck, planted overrun)", **card}
    if reason is not None:
        rec.update(status=f"not available: {reason}", errors=None)
    else:
        rc, text, secs = run_child(sanitizer_command(sanitizer, "memcheck", OVERRUN_PROGRAM),
                                   PROBE_TIMEOUT_S)
        found = _ERRORS.search(text)
        errors = int(found[1]) if found else None
        rec.update(errors=errors, seconds=round(secs, 3),
                   status="reported" if errors else "not reported")
    records.append(rec)
    log(f"sanitize self-test: {rec['status']} (errors {rec['errors']}) [{card['card']}]")
    shutil.rmtree(out, ignore_errors=True)
    return records


def verdict(records: List[dict]) -> int:
    """The exit code of a set of records: 1 on any error or failure, 2 when
    nothing could be checked, else 0."""
    statuses = [r["status"] for r in records]
    if any(s == "errors" or s.startswith("failed") or s == "not reported" for s in statuses):
        return 1
    if any(s.startswith("not available") for s in statuses):
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=DEFAULT_CASES,
                    help="least random cases of each entry point per tool")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--targets", default=None, help="comma-separated entry points (default: all)")
    ap.add_argument("--overrun", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from multithreading_string_matching_tpu_torch.tools.differential import (
        check_device,
        parse_targets,
    )

    check_device("cuda")
    if args.overrun:
        overrun()
        return 0
    parse_targets(args.targets)
    records = audit(args.cases, args.seed, args.targets)
    for rec in records:
        print(json.dumps(rec))
    return verdict(records)


if __name__ == "__main__":
    sys.exit(main())
