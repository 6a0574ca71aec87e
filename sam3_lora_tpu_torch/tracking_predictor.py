"""Interactive video tracking predictor (port of
``sam3_lora_tpu/tracking_predictor.py``): ``init_state`` on a video,
``add_new_points_or_box`` / ``add_new_mask`` to define objects on
conditioning frames, ``propagate_in_video`` to track every object through
the memory attention.

The inference state is one static (K objects, N memory slots)
``video.TrackState``: each propagation step is one batched pass over all
objects, with the memory bank in ``TrackerCore.assemble_memory``'s slot
layout (the cond frame in slot 0, then the ring of recent frames). It runs
on the processor's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .io_utils import VideoFrameSource
from .ops.interpolate import resize_bilinear
from .predictor import MAX_POINTS
from .video import TrackState, init_track_state, make_tracker_fns, video_tracker_core

__all__ = ["Sam3TrackerPredictor"]


@dataclass
class _SessionState:
    source: VideoFrameSource
    track: TrackState
    obj_slot: Dict[int, int] = field(default_factory=dict)  # user obj id -> slot
    cond_frame: Dict[int, int] = field(default_factory=dict)
    feats_cache: Dict[int, Tuple] = field(default_factory=dict)


class Sam3TrackerPredictor:
    """Click-, box- and mask-driven multi-object video tracking.

    ``tracker_params``: a JAX ``TrackerCore`` param tree (numpy or jax
    arrays), loaded through the weight bridge; None draws the port's own
    seeded init."""

    def __init__(
        self,
        processor,
        tracker_params=None,
        num_slots: int = 8,
        num_maskmem: int = 7,
        max_obj_ptrs: int = 16,
        seed: int = 0,
    ):
        self.proc = processor
        cfg = self.cfg = processor.cfg
        self.device = processor.device
        self.num_slots = num_slots
        self.num_maskmem = num_maskmem
        self.max_obj_ptrs = max_obj_ptrs
        fh = cfg.img_size // cfg.patch_size
        self.feat_hw = (fh, fh)
        self.mem_dim = max(cfg.d_model // 4, 8)
        self.core = video_tracker_core(cfg, self.device, num_maskmem, max_obj_ptrs,
                                       tracker_params, seed)
        self._prop, self._update = make_tracker_fns(self.core, num_maskmem, max_obj_ptrs)
        self._state: Optional[_SessionState] = None

    def _click_masks(self, vis, hi0, hi1, coords, labels):
        """The no-memory heads on point prompts -> the best-IoU mask, its
        SAM token and the object score logit, per batch row."""
        cond = self.core.no_memory_features(vis)
        masks, iou, tok, obj = self.core.predict_masks(cond, [hi0, hi1], point_coords=coords,
                                                       point_labels=labels,
                                                       multimask_output=True)
        best = iou.argmax(dim=-1)
        i = torch.arange(masks.shape[0], device=best.device)
        return masks[i, best], tok[i, best], obj[..., 0]

    def _encode_cond(self, vis, masks, obj_logits, tokens, state: TrackState,
                     slot: int) -> TrackState:
        """Write one object's cond memory and pointer into slot 0 of its
        bank."""
        mem = self.core.encode_memory(vis, masks[:, None],
                                      object_score_logits=obj_logits[:, None])["vision_features"]
        ptr = self.core.project_obj_ptr(tokens, obj_logits > 0)
        maskmem, age = state.maskmem.clone(), state.maskmem_age.clone()
        ptrs, page = state.obj_ptrs.clone(), state.obj_ptr_age.clone()
        maskmem[slot, 0] = mem[0]
        age[slot, 0] = 0
        ptrs[slot, 0] = ptr[0]
        page[slot, 0] = 0
        return state._replace(maskmem=maskmem, maskmem_age=age, obj_ptrs=ptrs, obj_ptr_age=page)

    # ------------------------------------------------------------------ #
    def _new_track(self) -> TrackState:
        mr = self.cfg.mask_loss_resolution
        return init_track_state(self.num_slots, (mr, mr), self.num_maskmem, self.max_obj_ptrs,
                                self.mem_dim, self.cfg.d_model, self.feat_hw, device=self.device)

    def init_state(self, video) -> "Sam3TrackerPredictor":
        self._state = _SessionState(source=VideoFrameSource(video), track=self._new_track())
        return self

    def reset_state(self) -> None:
        if self._state is not None:
            self._state = _SessionState(source=self._state.source, track=self._new_track())

    def _frame_feats(self, frame_idx: int):
        st = self._state
        if frame_idx not in st.feats_cache:
            self.proc.set_image(st.source.get(frame_idx))
            feats, poss = self.proc._state["feats"], self.proc._state["poss"]
            st.feats_cache[frame_idx] = (feats[-1], poss[-1], feats[0], feats[1])
        return st.feats_cache[frame_idx]

    def _slot_for(self, obj_id: int) -> int:
        st = self._state
        if obj_id not in st.obj_slot:
            if len(st.obj_slot) >= self.num_slots:
                raise RuntimeError(f"more than {self.num_slots} objects")
            st.obj_slot[obj_id] = len(st.obj_slot)
        return st.obj_slot[obj_id]

    def _define(self, slot: int, obj_id: int, mask: torch.Tensor) -> None:
        """Mark ``slot`` live as ``obj_id`` with its track mask ``mask``
        resized to the track resolution."""
        tr = self._state.track
        alive, ids, masks = tr.alive.clone(), tr.obj_ids.clone(), tr.masks.clone()
        alive[slot] = True
        ids[slot] = obj_id
        masks[slot] = resize_bilinear(mask.float(), tr.masks.shape[1:], antialias=True)
        self._state.track = tr._replace(alive=alive, obj_ids=ids, masks=masks)

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def add_new_points_or_box(
        self,
        frame_idx: int,
        obj_id: int,
        points: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        box: Optional[np.ndarray] = None,
    ) -> Tuple[int, np.ndarray]:
        """Define or refine an object on a conditioning frame from clicks
        and a box. -> (obj_id, low-resolution mask logits)."""
        if self._state is None:
            raise RuntimeError("call init_state first")
        st = self._state
        slot = self._slot_for(obj_id)
        vis, pos, hi0, hi1 = self._frame_feats(frame_idx)

        r = self.cfg.img_size
        h, w = st.source.get(frame_idx).shape[:2]
        coords = np.zeros((1, MAX_POINTS, 2), np.float32)
        labs = np.full((1, MAX_POINTS), -1, np.int64)
        n = 0
        if box is not None:
            coords[0, :2] = np.asarray(box, np.float32).reshape(2, 2)
            labs[0, :2] = (2, 3)
            n = 2
        if points is not None:
            pc = np.asarray(points, np.float32).reshape(-1, 2)
            pl = np.asarray(labels, np.int64).reshape(-1)
            m = min(len(pc), MAX_POINTS - n)
            coords[0, n:n + m] = pc[:m]
            labs[0, n:n + m] = pl[:m]
        coords = coords * np.array([r / w, r / h], np.float32)

        masks, tokens, obj_logits = self._click_masks(
            vis, hi0, hi1, torch.from_numpy(coords).to(self.device),
            torch.from_numpy(labs).to(self.device))
        st.track = self._encode_cond(vis, masks, obj_logits, tokens, st.track, slot)
        self._define(slot, obj_id, masks[0])
        st.cond_frame[obj_id] = frame_idx
        return obj_id, masks[0].float().cpu().numpy()

    @torch.inference_mode()
    def add_new_mask(self, frame_idx: int, obj_id: int, mask: np.ndarray) -> Tuple[int, np.ndarray]:
        """Define an object from a binary mask: the mask becomes +-10 logits
        (the mask-as-output convention) and seeds the cond memory."""
        if self._state is None:
            raise RuntimeError("call init_state first")
        st = self._state
        slot = self._slot_for(obj_id)
        vis, pos, hi0, hi1 = self._frame_feats(frame_idx)

        mr = 4 * self.feat_hw[0]
        m = torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)[None, None]
        m = resize_bilinear(m, (mr, mr), antialias=True)
        logits = (m[:, 0] > 0.5).float() * 20.0 - 10.0
        new_mem = self.core.encode_memory(
            vis, logits[:, None], skip_sigmoid=False,
            object_score_logits=torch.full((1, 1), 10.0, device=self.device))["vision_features"]
        tr = st.track
        maskmem, age = tr.maskmem.clone(), tr.maskmem_age.clone()
        maskmem[slot, 0] = new_mem[0]
        age[slot, 0] = 0
        st.track = tr._replace(maskmem=maskmem, maskmem_age=age)
        self._define(slot, obj_id, logits[0])
        st.cond_frame[obj_id] = frame_idx
        return obj_id, logits[0].cpu().numpy()

    # ------------------------------------------------------------------ #
    def propagate_in_video(
        self,
        start_frame_idx: Optional[int] = None,
        max_frame_num_to_track: Optional[int] = None,
    ):
        """Track every defined object through the video, yielding
        (frame_idx, obj_ids, low-resolution mask logits) per frame."""
        if self._state is None or not self._state.obj_slot:
            raise RuntimeError("add objects before propagating")
        st = self._state
        begin = min(st.cond_frame.values()) if start_frame_idx is None else start_frame_idx
        end = len(st.source)
        if max_frame_num_to_track is not None:
            end = min(end, begin + max_frame_num_to_track)

        for fi in range(begin, end):
            with torch.inference_mode():
                vis, pos, hi0, hi1 = self._frame_feats(fi)
                pm, ptok, plogits, _ = self._prop(st.track, vis, pos, hi0, hi1)
                alive = st.track.alive
                resized = resize_bilinear(pm.float(), st.track.masks.shape[1:], antialias=True)
                st.track = st.track._replace(
                    masks=torch.where(alive[:, None, None], resized, st.track.masks))
                st.track = self._update(st.track, vis, st.track.masks, plogits, ptok)
                live = alive.cpu().numpy()
                out = (fi, st.track.obj_ids.cpu().numpy()[live],
                       st.track.masks.cpu().numpy()[live])
            yield out
