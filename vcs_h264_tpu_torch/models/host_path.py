"""Frames and streams between host memory and the device, overlapped with
the device's work (the port's counterpart of the JAX package's
asynchronous dispatch).

On a CUDA device, host data is stacked straight into a pinned buffer and
copied on an upload stream with `non_blocking=True`; the current (compute)
stream waits for the copy on the device, not the host, so the upload of
batch k+1 runs while batch k is coded. Results come down the same way on a
download stream, into pinned buffers, and the host waits for a download
only when it reads it. Pinned buffers come from PyTorch's caching host
allocator, which hands a buffer out again only after the copies recorded
on it have completed; a device tensor used on another stream than the one
that allocated it is marked with `record_stream`, so the device allocator
does not reuse its memory early either. Pinning or a stream that fails on
a CUDA device raises: there is no quiet fall-back to pageable copies.

On the CPU nothing is pinned and there is no second stream: the same calls
run with plain buffers, in the same order. Either way this changes when
bytes move, never which bytes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Download:
    """A copy to host memory, complete once `wait()` returns; `nbytes`: the
    bytes it brings."""

    def __init__(self, host: torch.Tensor,
                 done: Optional[torch.cuda.Event]):
        self._host = host
        self._done = done
        self.nbytes = host.nbytes

    def wait(self) -> torch.Tensor:
        if self._done is not None:
            self._done.synchronize()
        return self._host


class HostPath:
    """Staged, asynchronous copies between host memory and `device`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def _buffer(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def upload_frames(self, arrays: Sequence[np.ndarray]) -> torch.Tensor:
        """Host arrays of one shape -> uint8 [N, ...] on the device (uint8
        crosses the host link, 4x less than int32)."""
        buf = self._buffer((len(arrays), *np.shape(arrays[0])), torch.uint8)
        np.stack(arrays, out=buf.numpy(), casting="unsafe")
        return self._upload(buf)

    def upload_stack(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Host tensors of one shape and dtype -> stacked on the device."""
        buf = self._buffer((len(tensors), *tensors[0].shape),
                           tensors[0].dtype)
        torch.stack(tuple(tensors), out=buf)
        return self._upload(buf)

    def _upload(self, buf: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return buf
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.h2d):
            dev = buf.to(self.device, non_blocking=True)
        compute.wait_stream(self.h2d)
        dev.record_stream(compute)
        return dev

    def download(self, t: torch.Tensor) -> Download:
        """Start the copy of `t` to host memory after the work queued so far
        on the current stream; `wait()` on the result returns it."""
        if not (self.cuda and t.is_cuda):
            return Download(t.cpu(), None)
        buf = self._buffer(t.shape, t.dtype)
        self.d2h.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.d2h):
            buf.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.d2h)
        t.record_stream(self.d2h)
        return Download(buf, done)
