"""Session-based video predictor (port of
``sam3_lora_tpu/video_predictor.py``): ``start_session`` / ``add_prompt``
/ ``propagate_in_video`` / ``get_output`` / ``close_session`` as a plain
in-process session manager.

Each session owns a frame source (``io_utils.VideoFrameSource``), a
``video.VideoGrounder`` state and its per-frame outputs. Sessions are
independent, so requests may interleave across sessions: each session's
device state lives in its own grounder. Every session runs on the shared
processor's device.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .io_utils import VideoFrameSource
from .video import VideoGrounder

__all__ = ["Sam3VideoPredictor", "VideoSession"]


@dataclass
class VideoSession:
    session_id: int
    source: VideoFrameSource
    grounder: VideoGrounder
    prompt: Optional[str] = None
    frame_outputs: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    cursor: int = 0

    @property
    def num_frames(self) -> int:
        return len(self.source)


class Sam3VideoPredictor:
    """The start_session / add_prompt / propagate / close lifecycle over
    one shared processor."""

    def __init__(self, processor, propagate_memory: bool = False, **grounder_kw):
        self.proc = processor
        self.propagate_memory = propagate_memory
        self.grounder_kw = grounder_kw
        self._sessions: Dict[int, VideoSession] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def start_session(self, video) -> int:
        """``video``: path (file or frame dir), list of frames, or array."""
        with self._lock:
            sid = next(self._ids)
            self._sessions[sid] = VideoSession(
                session_id=sid,
                source=VideoFrameSource(video),
                grounder=VideoGrounder(
                    self.proc, propagate=self.propagate_memory,
                    **self.grounder_kw,
                ),
            )
            return sid

    def _get(self, sid: int) -> VideoSession:
        if sid not in self._sessions:
            raise KeyError(f"unknown session {sid}")
        return self._sessions[sid]

    def add_prompt(self, sid: int, text: str) -> None:
        """Set / replace the text prompt; resets tracking state (the
        reference re-initializes detection state on prompt change)."""
        s = self._get(sid)
        s.prompt = text
        s.grounder.reset()
        s.frame_outputs.clear()
        s.cursor = 0

    def propagate_in_video(
        self,
        sid: int,
        start_frame: Optional[int] = None,
        max_frames: Optional[int] = None,
    ) -> Iterator[Dict[str, Any]]:
        """Stream per-frame outputs {frame_idx, obj_ids, scores,
        masks_lowres} (reference propagate_in_video generator)."""
        s = self._get(sid)
        if s.prompt is None:
            raise RuntimeError("add_prompt before propagate_in_video")
        begin = s.cursor if start_frame is None else start_frame
        end = s.num_frames if max_frames is None else min(
            s.num_frames, begin + max_frames
        )
        for idx in range(begin, end):
            frame = s.source.get(idx)
            out = s.grounder.step(frame, s.prompt)
            out = dict(out, frame_idx=idx)
            s.frame_outputs[idx] = out
            s.cursor = idx + 1
            yield out

    def get_output(self, sid: int, frame_idx: int) -> Dict[str, Any]:
        return self._get(sid).frame_outputs[frame_idx]

    def close_session(self, sid: int) -> None:
        s = self._sessions.pop(sid, None)
        if s is not None:
            s.source.close()

    def close(self) -> None:
        for sid in list(self._sessions):
            self.close_session(sid)
