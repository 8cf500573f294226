"""The serving inputs onto the card through one pinned staging buffer.

A copy from pageable host memory (``torch.as_tensor(x, device=cuda)``)
is synchronous: the CUDA driver stages it through its own small pinned
buffers on one host thread, and the host waits for the last byte.
:class:`CopyIn` owns one page-locked host buffer with one CUDA event. It
copies the caller's bytes into the buffer with torch's parallel CPU
``copy_`` (the intra-op threads, the GIL released), enqueues one
host-to-device copy with ``non_blocking=True`` on the current stream and
records the event; it returns while that copy is in flight, so that the
forward is dispatched behind it in stream order. A later call waits on
the event before it writes the buffer again. The buffer holds a whole
call's inputs (it grows to the largest call), so once a call returns its
inputs are in the buffer, and the caller may overwrite its arrays.

Which path an input takes follows from where it is: on a CPU model,
``torch.as_tensor``; a tensor on a device, ``Tensor.to`` (used as it is
where it is on the model's device); all host memory (numpy arrays, CPU
tensors, pinned or not), the buffer. The inputs cross the link as they
are (uint8 patches, float32 omic rows); nothing is cached by the
caller's address or content.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils.logging import count

# each input starts on this boundary of the buffers, so that a float32
# view of its bytes is aligned as an allocation is
ALIGN = 256


def layout(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """The offset of each input of ``sizes`` bytes in one buffer, each on
    an ``ALIGN`` boundary, and the buffer's bytes."""
    offsets, end = [], 0
    for n in sizes:
        start = -(-end // ALIGN) * ALIGN
        offsets.append(start)
        end = start + n
    return offsets, end


class CopyIn:
    """``copy_in(x_path, x_omic) -> (x_path, x_omic)`` on ``device``: the
    patches in their own dtype, the omic rows as float32.  Owned by one
    serving function; safe to call from several threads."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._buf: Optional[torch.Tensor] = None
        self._done: Optional[torch.cuda.Event] = None

    def __call__(self, x_path, x_omic) -> Tuple[torch.Tensor, torch.Tensor]:
        wanted = ((x_path, None), (x_omic, torch.float32))
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(x, dtype=dt, device=self.device)
                         for x, dt in wanted)
        out: List[Optional[torch.Tensor]] = [None, None]
        host = {}
        for i, (x, dt) in enumerate(wanted):
            if isinstance(x, torch.Tensor) and x.device.type != "cpu":
                out[i] = x.to(self.device, dt or x.dtype, non_blocking=True)
            else:
                host[i] = torch.as_tensor(x, dtype=dt).detach()
        if host:
            for i, t in zip(host, self._stage(list(host.values()))):
                out[i] = t
        return out[0], out[1]

    def _stage(self, srcs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The host tensors ``srcs`` on the device, through the buffer."""
        offsets, total = layout([s.nbytes for s in srcs])
        dst = torch.empty(total, dtype=torch.uint8, device=self.device)
        with self._lock:
            waits = self._reserve(total)
            for s, off in zip(srcs, offsets):
                _at(self._buf, off, s).copy_(s)
            dst.copy_(self._buf[:total], non_blocking=True)
            self._done.record(torch.cuda.current_stream(self.device))
        count("serve.copy_in_staged")
        count("serve.copy_in_waits", waits)
        return [_at(dst, off, s) for s, off in zip(srcs, offsets)]

    def _reserve(self, nbytes: int) -> int:
        """A buffer of at least ``nbytes`` whose last copy has ended; 1 if
        that copy was still in flight, else 0."""
        waits = 0
        if self._done is not None and not self._done.query():
            waits = 1
            self._done.synchronize()
        if self._buf is None or self._buf.numel() < nbytes:
            # a normal tensor, not an inference one, so that calls made
            # inside and outside torch.inference_mode may both write it
            with torch.inference_mode(False):
                self._buf = torch.empty(nbytes, dtype=torch.uint8,
                                        pin_memory=True)
            self._done = self._done or torch.cuda.Event()
        return waits


def _at(buf: torch.Tensor, off: int, like: torch.Tensor) -> torch.Tensor:
    """The bytes of ``buf`` from ``off`` as a contiguous tensor of
    ``like``'s dtype and shape."""
    return buf[off:off + like.nbytes].view(like.dtype).view(like.shape)
