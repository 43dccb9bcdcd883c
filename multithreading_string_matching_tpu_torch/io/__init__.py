"""Host-side readers and decoders: pattern files, pcap captures, payload
extraction, flow reassembly, synthetic corpora and the native ingest
bridge."""

from multithreading_string_matching_tpu_torch.io.patterns import load_patterns
from multithreading_string_matching_tpu_torch.io.pcap import (
    PcapFile,
    concat_pcaps,
    iter_pcap,
    open_capture,
    read_pcap,
    write_pcap,
)
from multithreading_string_matching_tpu_torch.io.decode import extract_payloads, PayloadBatch
from multithreading_string_matching_tpu_torch.io.flows import (
    FlowBatch,
    count_flows_chunked,
    extract_flows,
)

__all__ = [
    "FlowBatch",
    "extract_flows",
    "count_flows_chunked",
    "load_patterns",
    "read_pcap",
    "iter_pcap",
    "open_capture",
    "write_pcap",
    "concat_pcaps",
    "PcapFile",
    "extract_payloads",
    "PayloadBatch",
]
