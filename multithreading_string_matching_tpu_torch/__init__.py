"""multithreading_string_matching_tpu_torch — the packet-payload matcher on
PyTorch and CUDA for NVIDIA Hopper.

The port of ``multithreading_string_matching_tpu`` (JAX/Pallas on a TPU),
which stays beside it as the reference.  Module names follow the JAX
package's, so each module's counterpart is found by name:

- ``io``    — pattern files, classic-pcap ingest (one-shot and streamed),
              payload decode, flow reassembly, synthetic captures, the
              native C++ ingest bridge (host, numpy).
- ``models`` — the host-built automata: Aho-Corasick and the per-pattern
              KMP DFAs.
- ``ops``   — the window and table matchers and the DFA scans: staging
              plans, the plain PyTorch versions, and the hand-written CUDA
              kernels (``csrc/*.cu``).
- ``parallel`` — the flow monitor (``flow_stream.FlowStreamMatcher``), the
              device meshes (packet- and pattern-sharded), the streamed
              pipelines and their host threads.
- ``utils`` — phase timers and the reference-compatible report.
- ``api``   — :class:`Matcher`; ``cli`` — the ``serial``, ``data``,
              ``task``, ``synth`` and ``match`` commands.

Counting semantics are variant A of BASELINE.md: every overlapping
occurrence of every pattern (duplicates included, file order preserved)
within exactly ``payload_len`` bytes of each valid payload.

This package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import (
    read_pcap,
    iter_pcap,
    write_pcap,
    concat_pcaps,
    open_capture,
)
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads, PayloadBatch
from multithreading_string_matching_tpu_torch.models.kmp import lps_table, kmp_dfa, stack_kmp_dfas
from multithreading_string_matching_tpu_torch.models.aho_corasick import AhoCorasick
from multithreading_string_matching_tpu_torch.ops.scan import count_matches_kmp, count_matches_ac
from multithreading_string_matching_tpu_torch.api import Matcher

__all__ = [
    "load_patterns",
    "read_pcap",
    "iter_pcap",
    "open_capture",
    "write_pcap",
    "concat_pcaps",
    "extract_payloads",
    "PayloadBatch",
    "lps_table",
    "kmp_dfa",
    "stack_kmp_dfas",
    "AhoCorasick",
    "count_matches_kmp",
    "count_matches_ac",
    "Matcher",
    "__version__",
]
