"""Four places where the torch package differed from the JAX package, each
held to its repair on the CPU:

1. an Aho-Corasick scan from a state outside ``[0, dead]`` is refused with
   ``ValueError`` by every entry point (the JAX package's ``jnp.take``
   fills or wraps such an index instead, a result that is not the
   automaton's: the port refuses on purpose);
2. the packages' ``__all__`` (top level, ``io``, ``parallel``) are the JAX
   package's (``StreamMatcher`` included since the live path's port);
3. ``PayloadBatch`` has ``num_payloads`` and ``payload(i)``;
4. ``Matcher.pallas`` is a read-only alias of ``Matcher.kernels``.
"""

import numpy as np
import pytest
import torch

import multithreading_string_matching_tpu as jax_pkg
import multithreading_string_matching_tpu.io as jax_io
import multithreading_string_matching_tpu.parallel as jax_parallel
from multithreading_string_matching_tpu.io.decode import extract_payloads as jax_extract
from multithreading_string_matching_tpu.io.pcap import read_pcap as jax_read
from multithreading_string_matching_tpu.io.synth import synth_udp_pcap
import multithreading_string_matching_tpu_torch as pt_pkg
import multithreading_string_matching_tpu_torch.io as pt_io
import multithreading_string_matching_tpu_torch.parallel as pt_parallel
from multithreading_string_matching_tpu_torch.api import Matcher
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads
from multithreading_string_matching_tpu_torch.io.pcap import read_pcap
from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
from multithreading_string_matching_tpu_torch.ops import scan as tscan
from multithreading_string_matching_tpu_torch.parallel.mesh import count_chunk_sharded, make_mesh

torch.set_num_threads(1)

PATS = [b"ab", b"abc", b"bca", b"cab"]
NOT_PORTED = set()


def _lanes(n=6, L=32):
    rng = np.random.default_rng(1)
    payload = np.frombuffer(b"abc", np.uint8)[rng.integers(0, 3, (n, L))].astype(np.uint8)
    lengths = np.array([32, 32, 0, 10, 32, -1][:n], np.int32)
    return payload, lengths


def _bad_states(dead):
    S = dead + 1  # the number of states, the dead state included
    return [S, S + 7, -1, -5]


@pytest.mark.parametrize("k", range(4))
def test_ac_refuses_states_outside_the_table(k):
    ac = AhoCorasick.build(PATS)
    cac = tscan.CompiledAC.from_automaton(ac)
    payload, lengths = _lanes()
    n = payload.shape[0]
    bad = _bad_states(cac.dead)[k]
    states = np.zeros(n, np.int32)
    states[3] = bad
    p, l, st = torch.from_numpy(payload), torch.from_numpy(lengths), torch.from_numpy(states)
    calls = {
        "count_matches_ac": lambda: tscan.count_matches_ac(cac, payload, lengths,
                                                           initial_states=states),
        "ac_scan_plain": lambda: tscan.ac_scan_plain(cac, p, l, st),
        "ac_scan": lambda: tscan.ac_scan(cac, p, l, st),
        "ac_scan_tiles": lambda: tscan.ac_scan_tiles(cac, [(p, l)], states=[st]),
        "count_chunk": lambda: Matcher(PATS, engine="ac", device="cpu").count_chunk(
            payload, lengths, st),
        "count_chunk_sharded": lambda: count_chunk_sharded(cac, payload, lengths, st,
                                                           make_mesh(["cpu"] * 2)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match=r"\[0, \d+\]"):
            call()
    # The same lanes from in-table states (the dead state included) pass.
    for good in (0, cac.dead, cac.dead - 1):
        states[3] = good
        counts, new = tscan.count_matches_ac(cac, payload, lengths, initial_states=states,
                                             per_packet=True, return_states=True)
        assert counts[0].sum() > 0 and new[2] == 0 and new[5] == 0
        if good == cac.dead:
            assert not counts[3].any() and new[3] == cac.dead


def test_exports_equal_jax():
    for pt, jx in ((pt_pkg, jax_pkg), (pt_io, jax_io), (pt_parallel, jax_parallel)):
        assert sorted(pt.__all__) == sorted(set(jx.__all__) - NOT_PORTED), pt.__name__
        for name in pt.__all__:
            assert getattr(pt, name) is not None
    assert pt_pkg.__version__ == jax_pkg.__version__
    assert pt_pkg.write_pcap.__module__.startswith("multithreading_string_matching_tpu_torch")
    assert pt_pkg.count_matches_ac is tscan.count_matches_ac
    assert "``flow_stream`` so far" not in pt_parallel.__doc__
    assert "the ``serial`` and ``match``\n" not in pt_pkg.__doc__


def test_payload_batch_members_equal_jax(tmp_path):
    path = tmp_path / "cap.pcap"
    synth_udp_pcap(path, 40, payload_len=60, payload_len_jitter=40, invalid_rate=0.1, seed=3)
    got = extract_payloads(read_pcap(path), "udp", pad_n_to=16, pad_len_to=8)
    want = jax_extract(jax_read(path), "udp", pad_n_to=16, pad_len_to=8)
    assert got.num_payloads == want.num_payloads == got.payloads.shape[0]
    assert isinstance(got.num_payloads, int)
    for i in range(got.num_payloads):
        assert got.payload(i) == want.payload(i)
        assert len(got.payload(i)) == max(0, int(got.lengths[i]))


def test_matcher_pallas_is_kernels():
    m = Matcher(PATS, device="cpu")
    assert m.pallas is m.kernels
    assert type(m).pallas.fset is None
    with pytest.raises(AttributeError):
        m.pallas = None
    big = Matcher([b"rs%06d" % i for i in range(600)], device="cpu")
    assert big.pallas is big.kernels and type(big.pallas).__name__ == "CudaTableMatcher"
