"""Host-side video ingest and egress (counterpart of
`vcs_h264_tpu/io/video.py`): a reader with a background prefetch thread
that crops frames to a block multiple, a writer that picks the first
fourcc this OpenCV build opens, and the grouping of frames into GOPs.

cv2 is imported inside the functions that use it, never with the module:
the port runs on machines without OpenCV as long as no video file is read
or written."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _require_cv2():
    import cv2
    return cv2


class VideoReader:
    """Iterates BGR uint8 frames, cropped to a block multiple, with
    background prefetch."""

    def __init__(self, path: str, block_multiple: int = 8,
                 prefetch: int = 16, max_frames: Optional[int] = None):
        cv2 = _require_cv2()
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 25.0
        self.block_multiple = block_multiple
        self.out_h = self.height - self.height % block_multiple
        self.out_w = self.width - self.width % block_multiple
        self.max_frames = max_frames
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        n = 0
        while self.max_frames is None or n < self.max_frames:
            ok, frame = self.cap.read()
            if not ok:
                break
            self._queue.put(frame[: self.out_h, : self.out_w])
            n += 1
        self._queue.put(None)
        self.cap.release()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self._queue.get()
            if frame is None:
                return
            yield frame

    def read_all(self) -> List[np.ndarray]:
        return list(self)


class VideoWriter:
    """BGR uint8 frame sink. fourcc "auto" tries X264, then avc1, then
    mp4v: the first codec this OpenCV build opens."""

    def __init__(self, path: str, width: int, height: int, fps: float = 25.0,
                 fourcc: str = "auto"):
        cv2 = _require_cv2()
        candidates = ["X264", "avc1", "mp4v"] if fourcc == "auto" else [fourcc]
        self.out = None
        for fc in candidates:
            out = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*fc), fps, (width, height))
            if out.isOpened():
                self.out, self.fourcc = out, fc
                break
            out.release()
        if self.out is None:
            raise RuntimeError(
                f"no usable fourcc among {candidates} for {path}")

    def write(self, frame: np.ndarray) -> None:
        self.out.write(np.ascontiguousarray(frame, dtype=np.uint8))

    def close(self) -> None:
        self.out.release()


def group_into_gops(frames: Sequence[np.ndarray], gop_len: int
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[frames] -> [(i_frame [H, W, 3], p_frames [P, H, W, 3])] with the
    dispatch `frame_num % gop_len == 0 -> I`."""
    gops = []
    for start in range(0, len(frames), gop_len):
        chunk = frames[start:start + gop_len]
        i_frame = chunk[0]
        p = np.stack(chunk[1:]) if len(chunk) > 1 else \
            np.zeros((0, *i_frame.shape), i_frame.dtype)
        gops.append((i_frame, p))
    return gops
