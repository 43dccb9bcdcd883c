"""Streaming and multi-device execution on PyTorch: device meshes (packet
and pattern axes), the streamed pipelines and their host threads, the live
path's stream matcher (``StreamMatcher``) and the flow monitor."""

from multithreading_string_matching_tpu_torch.parallel.mesh import (
    make_mesh,
    count_matches_sharded,
    shard_batch,
)
from multithreading_string_matching_tpu_torch.parallel.pattern_shard import (
    count_matches_pattern_sharded,
    count_rows_pattern_sharded,
    make_pattern_mesh,
    make_2d_mesh,
)
from multithreading_string_matching_tpu_torch.parallel.pipeline import count_pcap_pipelined
from multithreading_string_matching_tpu_torch.parallel.stream import StreamMatcher
from multithreading_string_matching_tpu_torch.parallel.flow_stream import FlowStreamMatcher

__all__ = [
    "FlowStreamMatcher",
    "count_matches_pattern_sharded",
    "count_rows_pattern_sharded",
    "make_pattern_mesh",
    "make_2d_mesh",
    "make_mesh",
    "count_matches_sharded",
    "shard_batch",
    "count_pcap_pipelined",
    "StreamMatcher",
]
