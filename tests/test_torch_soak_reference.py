"""The port's verification tools against the JAX package, on the CPU.

- The flow cases of ``tools/fuzz_soak.py`` draw what the JAX soak's
  ``bench/fuzz_soak._flow_case`` draws: given the same generator, both pass
  and leave it in the same state, so they ran the same case.  The JAX soak
  is loaded by path (it runs JAX on the CPU; nothing in ``bench/`` changes).
  The four seeds cover both flow engines, a reordered wire, v6 and VLAN
  keys, a checkpoint, a reload and offsets.
- The edge cases of ``tools/edges.py`` at a limit of 2^16: the counts, rows
  and triples known by construction equal the port's plain versions and
  the JAX ``Matcher`` on the same tiles (integers: tolerance 0).
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from multithreading_string_matching_tpu import Matcher as JaxMatcher
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.tools import edges, fuzz_soak

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FLOW_SEEDS = (1, 4, 11, 13)


@functools.lru_cache(maxsize=1)
def jax_soak():
    spec = importlib.util.spec_from_file_location("bench_fuzz_soak", REPO / "bench" / "fuzz_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flow_inputs(seed):
    crng = np.random.default_rng(seed)
    pats, payloads, lengths = fuzz_soak.random_case(crng)
    return pats, [payloads[i, : lengths[i]].tobytes() for i in range(len(lengths))]


@pytest.mark.parametrize("seed", FLOW_SEEDS)
def test_flow_case_draws_what_the_jax_soak_draws(seed):
    pats, texts = flow_inputs(seed)
    a, b = np.random.default_rng(1000 + seed), np.random.default_rng(1000 + seed)
    ok, detail = jax_soak()._flow_case(pats, texts, a)
    assert ok, detail
    assert fuzz_soak.flow_case(pats, texts, b, "cpu") is None
    assert a.bit_generator.state == b.bit_generator.state


def test_flow_seeds_cover_the_flow_case(monkeypatch):
    """Across the four seeds: both engines, a reordered wire, v6 and VLAN
    keys, offsets, a checkpoint and a reload."""
    from multithreading_string_matching_tpu_torch.parallel import flow_stream

    seen = []
    cls = flow_stream.FlowStreamMatcher
    init, save, reload = cls.__init__, cls.save, cls.reload

    def rec_init(self, *a, **k):
        seen.append(("engine", k["engine"]))
        seen.extend((name, True) for name in ("reorder", "ipv6", "vlan", "collect_offsets")
                    if k[name])
        init(self, *a, **k)

    monkeypatch.setattr(cls, "__init__", rec_init)
    monkeypatch.setattr(cls, "save", lambda self, p: seen.append(("save", True)) or save(self, p))
    monkeypatch.setattr(cls, "reload",
                        lambda self, m: seen.append(("reload", True)) or reload(self, m))
    for seed in FLOW_SEEDS:
        pats, texts = flow_inputs(seed)
        assert fuzz_soak.flow_case(pats, texts, np.random.default_rng(1000 + seed), "cpu") is None
    assert set(seen) == {("engine", "window"), ("engine", "ac"), ("reorder", True),
                         ("ipv6", True), ("vlan", True), ("collect_offsets", True),
                         ("save", True), ("reload", True)}


@pytest.mark.parametrize("view", ["n_rep", "n_max", "n_buf"])
def test_edge_construction_equals_plain_and_jax(view):
    g = edges.geometry(2**16)
    p, l = edges.host_tile(g)
    rows = getattr(g, view)
    p, l = p[:rows], l[:rows]
    pats = list(edges.PATTERNS)
    want = edges.expected_totals(g, rows, pats)
    assert sum(want) > 0
    # Matcher's staging takes lengths inside the width (the kernels clamp,
    # and the edge cases hand them the raw ones): the clamped lengths count
    # the same.
    l = np.clip(l, 0, g.L)
    port = Matcher(pats, device="cpu")
    jaxm = JaxMatcher(pats)
    for engine in ("pallas", "ac", "kmp"):
        got = port.count(p, l, engine=engine).tolist()
        assert got == want == np.asarray(jaxm.count(p, l, engine=engine)).tolist()
    per_row = port.count(p, l, per_packet=True)
    assert np.array_equal(per_row, np.asarray(jaxm.count(p, l, per_packet=True)))
    for r, c in edges.expected_rows(g, rows, pats).items():
        assert per_row[r].tolist() == c
    assert int(per_row.sum()) == sum(want)
    uniq = list(port.window.unique_patterns)
    assert uniq == [bytes(u) for u in jaxm.window.unique_patterns]
    triples = [tuple(t) for t in np.asarray(jaxm.find_matches(p, l)).tolist()]
    assert triples == edges.expected_triples(g, rows, uniq)
    assert [tuple(t) for t in port.find_matches(p, l).tolist()] == triples
