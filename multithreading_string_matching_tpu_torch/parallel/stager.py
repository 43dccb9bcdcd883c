"""Pinned, double-buffered staging of host tiles onto the device.

The JAX package's streamed paths get their producer/consumer overlap from
asynchronous dispatch and a fresh numpy buffer per tile
(``multithreading_string_matching_tpu/parallel/pipeline.py:401-431``).  In
PyTorch a copy from pageable host memory blocks the host, so the overlap is
built here: :class:`TileStager` keeps a ring of slots, each a pinned host
tile with its own device twin.  The host fills one slot while earlier
slots' copies run on a dedicated copy stream and their kernels on the
compute (current) stream:

- :meth:`TileStager.host` hands out numpy views of the next slot's host
  buffers, after waiting (host side) for that slot's last copy to leave
  them;
- :meth:`TileStager.dispatch` copies the slot to its device twin with
  ``non_blocking=True`` on the copy stream, after the copy stream waits for
  the last kernels that read that twin, makes the compute stream wait for
  the copy, and calls ``fn`` on the device tensors there.

Nothing here synchronises the host with the device but the wait for a
slot's copy, which with three slots is the copy of two tiles ago.

Under ``torch.profiler`` the stages are spans (``utils.timing.span``):
``msm.stage.alloc`` (slots built or grown), ``msm.stage.wait`` (the host
blocked on a slot's copy) and ``msm.stage.dispatch`` (the copies and
``fn`` enqueued; its child is the launch range of ``fn``'s kernel).  The
trace's device events time the copies and kernels themselves.

``device="cpu"`` runs the same class on plain CPU buffers with no streams:
``fn`` gets the host tensors themselves.  That is the explicit CPU path;
a stager on a CUDA device without a card raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, TypeVar

import numpy as np
import torch

from multithreading_string_matching_tpu_torch.ops.cuda_window import canonical_device
from multithreading_string_matching_tpu_torch.utils.timing import span

R = TypeVar("R")

# Three slots: the host packs one while the card copies the next and scans
# the last, so the host waits only when it is two tiles ahead.
SLOTS = 3


class TileStager:
    """A ring of :data:`SLOTS` staging slots of at least ``rows`` x ``width``
    bytes and ``rows`` fills each; a request for a larger tile grows every
    slot (after one device synchronise), so callers whose tile shape varies
    size the slots to the largest shape seen.
    """

    def __init__(self, device, rows: int, width: int):
        self.device = canonical_device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a cuda TileStager needs a CUDA device, and none is available")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported staging device {self.device}")
        self._cuda = self.device.type == "cuda"
        self._k = -1                 # the slot host() handed out last
        self._shape: Optional[Tuple[int, int]] = None
        self.copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._alloc(max(rows, 1) * max(width, 1), max(rows, 1))

    def _alloc(self, nbytes: int, nrows: int) -> None:
        pin = self._cuda
        self._cap = (nbytes, nrows)
        with span("msm.stage.alloc"):
            self._host = [(torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin),
                           torch.zeros(nrows, dtype=torch.int32, pin_memory=pin))
                          for _ in range(SLOTS)]
            if self._cuda:
                self._dev = [(torch.empty(nbytes, dtype=torch.uint8, device=self.device),
                              torch.empty(nrows, dtype=torch.int32, device=self.device))
                             for _ in range(SLOTS)]
                self._copied: List[Optional[torch.cuda.Event]] = [None] * SLOTS
                self._used: List[Optional[torch.cuda.Event]] = [None] * SLOTS

    def host(self, rows: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(payload uint8[rows, width], fill int32[rows])``: numpy views of
        the next slot's host buffers, free to write.  Their contents are
        whatever the slot held last: the caller writes every byte it
        dispatches."""
        if rows * width > self._cap[0] or rows > self._cap[1]:
            if self._cuda:
                torch.cuda.synchronize(self.device)  # every slot idle before it is freed
            self._alloc(max(rows * width, self._cap[0]), max(rows, self._cap[1]))
        self._k = (self._k + 1) % SLOTS
        if self._cuda and self._copied[self._k] is not None:
            with span("msm.stage.wait"):
                self._copied[self._k].synchronize()
        self._shape = (rows, width)
        p, f = self._views(self._host[self._k])
        return p.numpy(), f.numpy()

    def _views(self, pair, rows: Optional[int] = None):
        width = self._shape[1]
        rows = self._shape[0] if rows is None else rows
        return pair[0][: rows * width].view(rows, width), pair[1][:rows]

    def dispatch(self, fn: Callable[[torch.Tensor, torch.Tensor], R],
                 rows: Optional[int] = None) -> R:
        """``fn(payload, fill)`` on the device copy of the slot :meth:`host`
        handed out last (on the CPU: the host tensors), launched on the
        current stream; returns what ``fn`` returns, without waiting.
        ``rows`` copies and counts only the slot's first rows (a partial
        tile)."""
        if self._shape is None:
            raise RuntimeError("dispatch() before host()")
        if rows is not None and not 0 <= rows <= self._shape[0]:
            raise ValueError(f"rows={rows} outside the slot's {self._shape[0]} rows")
        with span("msm.stage.dispatch"):
            k = self._k
            hp, hf = self._views(self._host[k], rows)
            if not self._cuda:
                return fn(hp, hf)
            dp, df = self._views(self._dev[k], rows)
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                if self._used[k] is not None:
                    # The twin's last kernels must be done reading it.
                    self.copy_stream.wait_event(self._used[k])
                dp.copy_(hp, non_blocking=True)
                df.copy_(hf, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self.copy_stream)
            self._copied[k] = copied
            compute.wait_event(copied)
            out = fn(dp, df)
            used = torch.cuda.Event()
            used.record(compute)
            self._used[k] = used
            return out
