"""A time limit for every test: a wait that never ends fails its own test.

Each test (setup, call and teardown together) runs under ``signal.alarm``
of :data:`TEST_LIMIT_S`.  When it fires, every thread's stack is written to
a duplicate of the process's stderr taken at start-up (so it is not lost in
pytest's output capture), and ``TimeoutError`` is raised in the main thread:
the test fails with its own name and the process, an xdist worker included,
goes on with the next test.  The limit never exits the process: xdist would
send the crashed test to each replacement worker in turn, and the tests
queued behind it would never run.

A main thread stuck inside C code cannot run a Python signal handler, so
``faulthandler`` also dumps every stack a minute after the limit (without
exiting); the dump names the test's frames in the log.

This file imports nothing heavy: ``tests/conftest.py`` must still be the
first to import jax, after it has set the platform variables.
"""

import faulthandler
import os
import signal

import pytest

TEST_LIMIT_S = 300

_DUMP = pytest.StashKey[object]()


def pytest_configure(config):
    config.stash[_DUMP] = os.fdopen(os.dup(2), "w")


def pytest_unconfigure(config):
    config.stash[_DUMP].close()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    dump = item.config.stash[_DUMP]
    said = f"{item.nodeid} ran past its {TEST_LIMIT_S} s limit (conftest.TEST_LIMIT_S)"

    def on_alarm(signum, frame):
        dump.write(f"\n+++ {said}; every thread's stack:\n")
        dump.flush()
        faulthandler.dump_traceback(file=dump, all_threads=True)
        raise TimeoutError(said)

    previous = signal.signal(signal.SIGALRM, on_alarm)
    faulthandler.dump_traceback_later(TEST_LIMIT_S + 60, exit=False, file=dump)
    signal.alarm(TEST_LIMIT_S)
    try:
        return (yield)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, previous)
