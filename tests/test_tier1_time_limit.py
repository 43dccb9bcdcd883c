"""The per-test time limit of the repo's root ``conftest.py``.

A copy of that file, its limit cut to 2 s in the copy's text, runs beside a
file of three waits that never end (an ``Event``, a ``Queue``, a sleeping
child process) between two passing tests, in a pytest of its own, plain and
under xdist.  Each wait must fail with the limit's ``TimeoutError`` under
its own name, the tests around them pass, no worker go down and no child
outlive the run.
"""

import os
import pathlib
import re
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

ROOT_CONFTEST = pathlib.Path(__file__).resolve().parents[1] / "conftest.py"

HANGS = '''
import queue
import subprocess
import sys
import threading

CHILD = "import os, time; open({pid!r}, 'w').write(str(os.getpid())); time.sleep(600)"


def test_before():
    pass


def test_event_wait():
    threading.Event().wait()


def test_queue_get():
    queue.Queue().get()


def test_sleeping_child():
    subprocess.run([sys.executable, "-c", CHILD])


def test_after():
    pass
'''


def _alive(pid: int) -> bool:
    try:
        stat = pathlib.Path(f"/proc/{pid}/stat").read_text()
    except FileNotFoundError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


@pytest.mark.parametrize("workers", [[], ["-p", "xdist", "-n", "2", "--dist", "loadfile"]],
                         ids=["plain", "xdist"])
def test_a_stuck_wait_fails_its_own_test_at_the_limit(tmp_path, workers):
    text = ROOT_CONFTEST.read_text()
    cut = re.sub(r"^TEST_LIMIT_S = \d+$", "TEST_LIMIT_S = 2", text, count=1, flags=re.M)
    assert cut != text
    (tmp_path / "conftest.py").write_text(cut)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    pid_file = tmp_path / "child.pid"
    (tmp_path / "test_hangs.py").write_text(HANGS.replace("{pid!r}", repr(str(pid_file))))
    xml = tmp_path / "out.xml"
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         f"--rootdir={tmp_path}", f"--junitxml={xml}", *workers, str(tmp_path)],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"},
    )
    took = time.monotonic() - t0
    said = run.stdout + run.stderr
    assert run.returncode == 1, said
    cases = {c.get("name"): c for c in ET.parse(xml).getroot().iter("testcase")}
    assert sorted(cases) == sorted(["test_before", "test_event_wait", "test_queue_get",
                                    "test_sleeping_child", "test_after"]), said
    for name in ("test_before", "test_after"):
        assert len(cases[name]) == 0, (name, said)
    for name in ("test_event_wait", "test_queue_get", "test_sleeping_child"):
        (failure,) = cases[name].findall("failure")
        assert "TimeoutError" in failure.get("message"), (name, said)
        assert "ran past its 2 s limit" in failure.get("message"), (name, said)
    assert "node down" not in said and "replacing crashed worker" not in said, said
    assert "every thread's stack" in said, said
    assert not _alive(int(pid_file.read_text()))
    assert took < 60, took
