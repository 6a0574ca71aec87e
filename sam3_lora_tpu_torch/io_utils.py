"""Video and image IO with asynchronous prefetch: the PyTorch port's copy
of ``sam3_lora_tpu/io_utils.py`` (it imports no JAX);
``tests/test_torch_video_predictor.py`` holds the two equal.

A video file decodes through OpenCV's ``VideoCapture``, a directory of
frame images through PIL (both imported only on those paths), and a list
or array of frames is used as it is. ``AsyncVideoFrameLoader`` decodes
ahead of the consumer on a thread, so that host decode overlaps device
compute. Frames come out as (H, W, 3) uint8 RGB; resizing and
normalization happen in the consumer (the processor), so the decode
thread stays pure IO.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "VideoFrameSource",
    "load_video_frames",
    "AsyncVideoFrameLoader",
]

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".webp")


class VideoFrameSource:
    """Uniform random/sequential access over a video file, a directory of
    frame images, a list/array of frames, or a single image."""

    def __init__(self, src: Union[str, Sequence, np.ndarray]):
        self._cap = None
        self._files: Optional[List[str]] = None
        self._frames: Optional[Sequence] = None

        if isinstance(src, str):
            if os.path.isdir(src):
                files = sorted(
                    os.path.join(src, f)
                    for f in os.listdir(src)
                    if f.lower().endswith(IMG_EXTS)
                )
                if not files:
                    raise FileNotFoundError(f"no frame images in {src}")
                self._files = files
                self._len = len(files)
            else:
                import cv2

                cap = cv2.VideoCapture(src)
                if not cap.isOpened():
                    raise IOError(f"cannot open video: {src}")
                self._cap = cap
                self._len = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                self._next_idx = 0
                self._lock = threading.Lock()
        elif isinstance(src, np.ndarray) and src.ndim == 3:
            self._frames = [src]
            self._len = 1
        else:
            self._frames = list(src)
            self._len = len(self._frames)

    def __len__(self) -> int:
        return self._len

    def get(self, idx: int) -> np.ndarray:
        if self._frames is not None:
            return np.asarray(self._frames[idx])
        if self._files is not None:
            from PIL import Image

            return np.asarray(Image.open(self._files[idx]).convert("RGB"))
        import cv2

        with self._lock:
            if idx != self._next_idx:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
            ok, bgr = self._cap.read()
            self._next_idx = idx + 1
        if not ok:
            raise IndexError(f"frame {idx} unreadable")
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)

    def close(self):
        if self._cap is not None:
            self._cap.release()


def load_video_frames(
    src, max_frames: Optional[int] = None
) -> List[np.ndarray]:
    """Eagerly decode all (or the first ``max_frames``) frames — the
    reference's synchronous loader path (io_utils.py load_video_frames)."""
    vs = VideoFrameSource(src)
    n = len(vs) if max_frames is None else min(len(vs), max_frames)
    try:
        return [vs.get(i) for i in range(n)]
    finally:
        vs.close()


class AsyncVideoFrameLoader:
    """Background-thread prefetching frame iterator (the reference's async
    loader, io_utils.py:~200-400): decode runs ``prefetch`` frames ahead so
    the consumer (device compute) never waits on IO for sequential access.

    Usage::

        loader = AsyncVideoFrameLoader("video.mp4", prefetch=4)
        for frame in loader:          # (H, W, 3) uint8 RGB
            grounder.step(frame, prompt)
    """

    def __init__(self, src, prefetch: int = 4, max_frames: Optional[int] = None):
        self.source = VideoFrameSource(src)
        self.num_frames = (
            len(self.source)
            if max_frames is None
            else min(len(self.source), max_frames)
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for i in range(self.num_frames):
                self._q.put((i, self.source.get(i)))
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(None)
            self.source.close()

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item[1]
