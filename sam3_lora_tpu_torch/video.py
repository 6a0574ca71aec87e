"""Video grounding and tracking over static object slots (port of
``sam3_lora_tpu/video.py``).

Per frame, the detector finds the text-prompted instances, the tracker
propagates every live object through memory attention, and detections are
associated with tracks to spawn, refresh and retire objects. The tracked
objects are one ``TrackState`` of fixed-size tensors with ``K`` slots:
objects are a batch dimension, so each per-frame stage is one batched
computation on the device.

Also the heuristic tail: occlusion-based overlap suppression
(``suppress_by_recent_occlusion``), reconditioning
(``plan_reconditioning`` / ``apply_reconditioning``) and hole filling
(``fill_holes_in_mask_scores``, batched connected components).

Integer state is int32 with the JAX package's sentinels (-1 free, 10**6 for
a free ring slot when picking the oldest); ties in ``argmax`` take the first
index and the spawn order sorts stably, as ``jnp.argmax`` / ``jnp.argsort``
do. Every stage runs on the device of the processor it is given.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .models.builder import init_model
from .ops.association import associate_det_trk
from .ops.boxes import fast_diag_box_iou
from .ops.cc import component_sizes, connected_components
from .ops.masks import mask_iou, masks_to_boxes
from .ops.nms import nms_masks
from .ops.posenc import sine_pos_grid
from .predictor import tracker_core
from .utils.checkpoint import load_jax_tree


class TrackState(NamedTuple):
    """Fixed K-slot tracked-object state: per object ``num_maskmem``
    spatial memory frames (slot 0 the spawn ("cond") frame, slots 1.. a
    ring of recent frames, each with an age) and a ring of object
    pointers."""

    alive: torch.Tensor           # (K,) bool
    obj_ids: torch.Tensor         # (K,) int32, stable external ids, -1 free
    masks: torch.Tensor           # (K, Hm, Wm) float32 last-frame mask logits
    scores: torch.Tensor          # (K,) float32 running score
    maskmem: torch.Tensor         # (K, N, mem_dim, Hf, Wf) spatial memories
    maskmem_age: torch.Tensor     # (K, N) int32 frames since written, -1 free
    obj_ptrs: torch.Tensor        # (K, P, d_model) pointer ring
    obj_ptr_age: torch.Tensor     # (K, P) int32, -1 free
    missing_frames: torch.Tensor  # (K,) int32 keep-alive counter
    hotstart: torch.Tensor        # (K,) int32 frames since spawn
    last_occluded: torch.Tensor   # (K,) int32 frame of last occlusion, -1 never
    frame_idx: torch.Tensor       # () int32 current frame
    next_id: torch.Tensor         # () int32


NEVER_OCCLUDED = -1
# larger than any frame index: objects retired this frame always lose
# overlap-suppression ties
ALWAYS_OCCLUDED = 100000
NO_OBJ_LOGIT = -10.0
FREE_AGE = 10**6  # a free ring slot counts as the oldest


def init_track_state(
    num_slots: int,
    mask_hw: Tuple[int, int],
    num_maskmem: int = 7,
    max_obj_ptrs: int = 16,
    mem_dim: int = 64,
    d_model: int = 256,
    feat_hw: Tuple[int, int] = (72, 72),
    device=None,
) -> TrackState:
    k = num_slots

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=device)

    return TrackState(
        alive=full((k,), False, torch.bool),
        obj_ids=full((k,), -1),
        masks=full((k,) + tuple(mask_hw), 0.0, torch.float32),
        scores=full((k,), 0.0, torch.float32),
        maskmem=full((k, num_maskmem, mem_dim) + tuple(feat_hw), 0.0, torch.float32),
        maskmem_age=full((k, num_maskmem), -1),
        obj_ptrs=full((k, max_obj_ptrs, d_model), 0.0, torch.float32),
        obj_ptr_age=full((k, max_obj_ptrs), -1),
        missing_frames=full((k,), 0),
        hotstart=full((k,), 0),
        last_occluded=full((k,), NEVER_OCCLUDED),
        frame_idx=full((), 0),
        next_id=full((), 0),
    )


def associate_and_update(
    state: TrackState,
    det_masks: torch.Tensor,      # (N, Hm, Wm) detector mask logits
    det_scores: torch.Tensor,     # (N,)
    det_valid: torch.Tensor,      # (N,) bool (already thresholded and NMS'd)
    iou_threshold: float = 0.5,
    max_missing_frames: int = 8,
    hotstart_frames: int = 2,
    new_det_thresh: float = 0.5,
) -> TrackState:
    """One association step: refresh the matched tracks, spawn new ones
    into free slots, retire tracks unseen for ``max_missing_frames`` (past
    their hotstart grace period)."""
    k = state.alive.shape[0]
    dev = state.alive.device
    out = associate_det_trk(
        det_masks, state.masks, det_valid=det_valid, trk_valid=state.alive,
        det_scores=det_scores, iou_threshold=iou_threshold, iou_threshold_trk=iou_threshold,
        new_det_thresh=new_det_thresh,
    )

    # refresh matched tracks: adopt the best-IoU detection's mask and score
    best_det = out.iou.argmax(dim=0)
    matched = state.alive & ~out.unmatched_trk
    masks = torch.where(matched[:, None, None], det_masks[best_det], state.masks)
    scores = torch.where(matched, out.matched_det_score, state.scores * 0.9)
    missing = torch.where(matched, 0, state.missing_frames + 1).to(torch.int32)

    alive = state.alive & ~((missing > max_missing_frames) & (state.hotstart >= hotstart_frames))

    # spawn new detections into free slots (free slots x new detections,
    # each in its stable order)
    free = ~alive
    new_order = torch.argsort((~out.new_det).to(torch.uint8), stable=True)
    slot_order = torch.argsort((~free).to(torch.uint8), stable=True)
    n_new = torch.minimum(out.new_det.sum(), free.sum())
    take = torch.arange(k, device=dev) < n_new
    spawn_slots = slot_order[:k]
    # fewer detection rows than slots: pad the order (never taken, n_new <= N)
    n_det = new_order.shape[0]
    spawn_dets = F.pad(new_order, (0, k - n_det)) if n_det < k else new_order[:k]
    is_spawn = torch.zeros((k,), dtype=torch.bool, device=dev)
    is_spawn[spawn_slots] = take
    det_for_slot = torch.zeros((k,), dtype=torch.long, device=dev)
    det_for_slot[spawn_slots] = spawn_dets

    alive_new = alive | is_spawn
    masks = torch.where(is_spawn[:, None, None], det_masks[det_for_slot], masks)
    scores = torch.where(is_spawn, det_scores[det_for_slot], scores)
    missing = torch.where(is_spawn, 0, missing).to(torch.int32)
    hotstart = torch.where(is_spawn, 0, state.hotstart + 1).to(torch.int32)
    spawn_rank = torch.cumsum(is_spawn.to(torch.int32), 0) - 1
    obj_ids = torch.where(is_spawn, state.next_id + spawn_rank, state.obj_ids)
    obj_ids = torch.where(alive_new, obj_ids, -1).to(torch.int32)

    # spawned slots start with a clean memory bank (their cond frame is
    # written by this frame's memory update)
    fresh = is_spawn | ~alive_new
    maskmem_age = torch.where(fresh[:, None], -1, state.maskmem_age)
    obj_ptr_age = torch.where(fresh[:, None], -1, state.obj_ptr_age)

    # slots retired this frame always lose later overlap-suppression ties;
    # spawned slots start never occluded
    removed = state.alive & ~alive
    last_occluded = torch.where(removed, ALWAYS_OCCLUDED, state.last_occluded)
    last_occluded = torch.where(is_spawn, NEVER_OCCLUDED, last_occluded).to(torch.int32)

    return state._replace(
        alive=alive_new, obj_ids=obj_ids, masks=masks, scores=scores, maskmem_age=maskmem_age,
        obj_ptr_age=obj_ptr_age, missing_frames=missing, hotstart=hotstart,
        last_occluded=last_occluded, next_id=(state.next_id + n_new).to(torch.int32),
    )


# ---------------------------------------------------------------------------
# The heuristic tail
# ---------------------------------------------------------------------------


def _component_area(mask: torch.Tensor) -> torch.Tensor:
    """Each pixel's connected-component size (0 outside ``mask``), for a
    batch of (M, H, W) masks."""
    lab = connected_components(mask)
    sizes = component_sizes(lab)
    flat = lab.reshape(lab.shape[0], -1).long()
    area = sizes.gather(1, flat.clamp(min=0))
    return torch.where(flat >= 0, area, 0).reshape(mask.shape)


def fill_holes_in_mask_scores(
    mask_logits: torch.Tensor,
    max_area: int,
    fill_holes: bool = True,
    remove_sprinkles: bool = True,
) -> torch.Tensor:
    """Fill small background holes (-> +0.1) and remove small foreground
    sprinkles (-> -0.1) in mask logits (..., H, W). Sprinkle removal
    thresholds at ``min(max_area, foreground_area // 2)`` per mask. All
    masks are labelled in one batch."""
    if max_area <= 0:
        return mask_logits
    shape = mask_logits.shape
    m = mask_logits.reshape((-1,) + shape[-2:])
    if fill_holes:
        bg = m <= 0
        small = bg & (_component_area(bg) <= max_area)
        m = torch.where(small, 0.1, m)
    if remove_sprinkles:
        fg = m > 0
        thr = torch.minimum(torch.tensor(max_area, dtype=torch.int32, device=m.device),
                            fg.sum(dim=(-2, -1), dtype=torch.int32) // 2)
        small = fg & (_component_area(fg) <= thr[:, None, None])
        m = torch.where(small, -0.1, m)
    return m.reshape(shape)


def suppress_by_recent_occlusion(
    state: TrackState,
    iou_threshold: float,
    reverse: bool = False,
) -> TrackState:
    """Suppress overlapping track masks in favour of the less recently
    occluded object, then record this frame's occlusions: for an
    overlapping pair (i, j), i is suppressed iff ``occ_i > occ_j`` and
    ``occ_j > -1``. Suppressed masks become ``NO_OBJ_LOGIT``; occluded or
    suppressed objects get ``last_occluded = frame_idx``."""
    masks, alive, occ = state.masks, state.alive, state.last_occluded
    k = alive.shape[0]
    binary = masks > 0
    iou = mask_iou(binary, binary)
    pair = alive[:, None] & alive[None, :]
    upper = torch.ones((k, k), dtype=torch.bool, device=alive.device).triu(1)
    over = (iou >= iou_threshold) & pair & upper

    occ_i, occ_j = occ[:, None], occ[None, :]
    cmp = torch.gt if not reverse else torch.lt
    sup_i = over & cmp(occ_i, occ_j) & (occ_j > NEVER_OCCLUDED)
    sup_j = over & cmp(occ_j, occ_i) & (occ_i > NEVER_OCCLUDED)
    to_suppress = sup_i.any(dim=1) | sup_j.any(dim=0)

    is_occluded = ~binary.any(dim=-1).any(dim=-1)
    occ_or_sup = (is_occluded | to_suppress) & alive
    new_occ = torch.where(occ_or_sup, state.frame_idx, occ).to(torch.int32)
    new_masks = torch.where(to_suppress[:, None, None], NO_OBJ_LOGIT, masks)
    return state._replace(masks=new_masks, last_occluded=new_occ)


def plan_reconditioning(
    state: TrackState,
    det_masks: torch.Tensor,       # (N, Hm, Wm) detector mask logits
    det_scores: torch.Tensor,      # (N,)
    new_det: torch.Tensor,         # (N,) bool (association output)
    iou: torch.Tensor,             # (N, K) det x track mask IoU (association)
    recondition_every: int = -1,
    bbox_iou_thresh: float = 0.0,
    det_score_thresh: float = 0.8,
    high_conf_thresh: float = 0.8,
    high_iou_thresh: float = 0.8,
    obj_score_thresh: float = 0.8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which slots to recondition, and with which detection: periodically
    (every ``recondition_every`` frames) or on a box mismatch (track box
    against matched detection box IoU < ``bbox_iou_thresh`` with detection
    score >= ``det_score_thresh``), among each track's max-IoU
    high-confidence detections and the tracks whose running score clears
    ``obj_score_thresh``. -> (recondition (K,) bool, det_for_slot (K,)
    int64); apply with ``apply_reconditioning``."""
    n, k = iou.shape
    dev = iou.device
    qualify_det = (det_scores >= high_conf_thresh) & ~new_det
    det_max_trk = iou.argmax(dim=1)
    det_high_iou = iou.amax(dim=1) >= high_iou_thresh
    eligible = qualify_det & det_high_iou

    # per-slot best eligible detection by IoU
    mine = eligible[:, None] & (det_max_trk[:, None] == torch.arange(k, device=dev)[None, :])
    elig_iou = torch.where(mine, iou, -1.0)
    det_for_slot = elig_iou.argmax(dim=0)
    has_det = elig_iou.amax(dim=0) >= 0.0

    # box mismatch trigger
    hm, wm = state.masks.shape[-2:]
    scale = torch.tensor([wm, hm, wm, hm], dtype=torch.float32, device=dev)
    trk_boxes_n = masks_to_boxes(state.masks > 0) / scale
    det_boxes = masks_to_boxes(det_masks > 0) / scale
    pair_iou = fast_diag_box_iou(det_boxes[det_for_slot], trk_boxes_n)
    nonempty = (state.masks > 0).any(dim=-1).any(dim=-1)
    iou_trigger = ((bbox_iou_thresh > 0) & (pair_iou < bbox_iou_thresh)
                   & (det_scores[det_for_slot] >= det_score_thresh) & nonempty)
    periodic = (recondition_every > 0) & (state.frame_idx % max(recondition_every, 1) == 0)
    recondition = state.alive & has_det & (state.scores > obj_score_thresh) & (iou_trigger | periodic)
    return recondition, det_for_slot


def apply_reconditioning(
    state: TrackState,
    det_masks: torch.Tensor,
    recondition: torch.Tensor,
    det_for_slot: torch.Tensor,
) -> TrackState:
    """Adopt the detection's mask as the slot's new conditioning mask and
    reset its memory bank, so that the next memory update writes a fresh
    cond frame."""
    return state._replace(
        masks=torch.where(recondition[:, None, None], det_masks[det_for_slot], state.masks),
        maskmem_age=torch.where(recondition[:, None], -1, state.maskmem_age),
        obj_ptr_age=torch.where(recondition[:, None], -1, state.obj_ptr_age),
    )


# ---------------------------------------------------------------------------
# Tracker propagation (TrackerCore over the K object slots as a batch)
# ---------------------------------------------------------------------------


def _ring_write(age: torch.Tensor, alive: torch.Tensor, slot: torch.Tensor):
    """-> (write (K, N) bool: each live slot's one-hot ``slot``, the ages
    after the write: 0 where written, +1 where held, -1 where free)."""
    write = alive[:, None] & F.one_hot(slot, age.shape[1]).bool()
    return write, torch.where(write, 0, torch.where(age >= 0, age + 1, age)).to(torch.int32)


def make_tracker_fns(core, num_maskmem: int = 7, max_obj_ptrs: int = 16):
    """The two tracker stages over a ``TrackerCore`` (its weights are the
    module's):

    ``propagate(state, vis, pos, hi0, hi1)``: memory-conditioned mask
    prediction for all K slots -> (best-IoU masks (K, Hm, Wm), their SAM
    tokens (K, D), object score logits (K,), IoU predictions (K, 3));

    ``update_memory(state, vis, masks, obj_logits, tokens)``: encode the
    final per-object masks into the memory rings (slot 0 once, at spawn;
    then the oldest or a free ring slot) and the pointer ring, and advance
    the frame."""

    @torch.inference_mode()
    def propagate(state: TrackState, vis, pos, hi0, hi1):
        k = state.alive.shape[0]
        visk, posk, hi0k, hi1k = (t.expand((k,) + t.shape[1:]) for t in (vis, pos, hi0, hi1))
        mem, mpos, mmask, n_ptr, has_mem = memory_bank(core, state, num_maskmem, max_obj_ptrs)
        cond = core.condition_features(visk, posk, mem, mpos, mem_mask=mmask,
                                       num_obj_ptr_tokens=n_ptr)
        cond = torch.where(has_mem[:, None, None, None], cond, core.no_memory_features(visk))
        masks, iou, tokens, obj_logits = core.predict_masks(cond, [hi0k, hi1k],
                                                            multimask_output=True)
        best = iou.argmax(dim=-1)
        rows = torch.arange(k, device=best.device)
        return masks[rows, best], tokens[rows, best], obj_logits[..., 0], iou

    @torch.inference_mode()
    def update_memory(state: TrackState, vis, masks, obj_logits, tokens):
        k = state.alive.shape[0]
        visk = vis.expand((k,) + vis.shape[1:])
        new_mem = core.encode_memory(visk, masks[:, None],
                                     object_score_logits=obj_logits[:, None])["vision_features"]
        new_ptr = core.project_obj_ptr(tokens, obj_logits > 0)

        age = state.maskmem_age
        has_cond = age[:, 0] >= 0
        ring_age = torch.where(age[:, 1:] < 0, FREE_AGE, age[:, 1:])
        write_slot = torch.where(has_cond, 1 + ring_age.argmax(dim=1), 0)
        write, age = _ring_write(age, state.alive, write_slot)
        maskmem = torch.where(write[..., None, None, None], new_mem[:, None], state.maskmem)

        p_age = state.obj_ptr_age
        p_slot = torch.where(p_age < 0, FREE_AGE, p_age).argmax(dim=1)
        p_write, p_age = _ring_write(p_age, state.alive, p_slot)
        obj_ptrs = torch.where(p_write[..., None], new_ptr[:, None], state.obj_ptrs)
        return state._replace(maskmem=maskmem, maskmem_age=age, obj_ptrs=obj_ptrs,
                              obj_ptr_age=p_age, frame_idx=(state.frame_idx + 1).to(torch.int32))

    return propagate, update_memory


def memory_bank(core, state: TrackState, num_maskmem: int, max_obj_ptrs: int):
    """The memory attention's keys for every slot: -> (mem, mem_pos,
    mem_mask True = pad, num_obj_ptr_tokens, has_mem (K,) bool: a memory
    frame is valid)."""
    age = state.maskmem_age
    # slot 0 = cond frame -> t_pos 0; ring slots: latest -> num_maskmem - 1
    tpos = (num_maskmem - age).clamp(1, num_maskmem - 1)
    tpos[:, 0] = 0
    # a ring frame older than the window drops out (the cond frame never does)
    first = torch.arange(age.shape[1], device=age.device)[None] == 0
    mem_valid = (age >= 0) & (first | (age < num_maskmem))
    pos_grid = _maskmem_pos_grid(state.maskmem.shape, state.maskmem.device)
    mem, mpos, mmask, n_ptr = core.assemble_memory(
        state.maskmem, pos_grid, tpos, mem_valid, state.obj_ptrs,
        state.obj_ptr_age.clamp(min=0).float(), state.obj_ptr_age >= 0, num_frames=max_obj_ptrs)
    # pointer-only banks could mask every key of a dead slot: then keep them
    # all, so that its softmax stays finite
    mmask = mmask & ~mmask.all(dim=1, keepdim=True)
    return mem, mpos, mmask, n_ptr, mem_valid.any(dim=1)


def _maskmem_pos_grid(maskmem_shape, device) -> torch.Tensor:
    """The memory tokens' shared sine PE, broadcast to the bank's shape."""
    k, n, c, h, w = maskmem_shape
    return sine_pos_grid(h, w, num_pos_feats=c, device=device)[None, None].expand(maskmem_shape)


# the TrackerCore parameters a JAX init tree for the video grounder lacks:
# its init traces no mask-input downsampling
VIDEO_UNUSED = ("mask_downsample.",)


def video_tracker_core(cfg: ModelConfig, device, num_maskmem: int, max_obj_ptrs: int,
                       tracker_params=None, seed: int = 0):
    """A ``TrackerCore`` for the video tier on ``device``: a JAX
    ``TrackerCore`` param tree loaded through the weight bridge, or else a
    seeded init; in eval mode, without gradients."""
    core = tracker_core(cfg, device, num_maskmem=num_maskmem, max_obj_ptrs=max_obj_ptrs)
    if tracker_params is None:
        init_model(core, torch.Generator(device=device).manual_seed(seed))
    else:
        load_jax_tree(core, tracker_params, optional=VIDEO_UNUSED)
    return core.eval().requires_grad_(False)


class VideoGrounder:
    """Streaming text-prompted video grounding: per frame, the detector
    pass, (optionally) tracker memory propagation, association and the
    slot update. It runs on the processor's device.

    ``tracker_params``: a JAX ``TrackerCore`` param tree; with
    ``propagate`` and none, a seeded init (random weights)."""

    def __init__(
        self,
        processor,                    # Sam3Processor (backbone + grounding)
        num_slots: int = 16,
        prob_threshold: float = 0.5,
        nms_iou: float = 0.7,
        num_maskmem: int = 7,
        max_obj_ptrs: int = 16,
        tracker_params=None,
        propagate: bool = False,      # run memory propagation each frame
        # the heuristic tail
        fill_hole_area: int = 16,
        occlusion_suppression_iou: float = 0.0,   # 0 disables
        recondition_every: int = -1,              # -1 disables periodic
        recondition_bbox_iou: float = 0.0,        # 0 disables the box trigger
        recondition_det_score: float = 0.0,
    ):
        self.proc = processor
        cfg = self.proc.cfg
        self.device = processor.device
        self.num_slots = num_slots
        self.prob_threshold = prob_threshold
        self.nms_iou = nms_iou
        self.num_maskmem = num_maskmem
        self.max_obj_ptrs = max_obj_ptrs
        self.propagate = propagate
        fh = cfg.img_size // cfg.patch_size
        self.feat_hw = (fh, fh)
        self.mem_dim = max(cfg.d_model // 4, 8)
        self.core = None
        if propagate or tracker_params is not None:
            self.core = video_tracker_core(cfg, self.device, num_maskmem, max_obj_ptrs,
                                           tracker_params)
        self.fill_hole_area = fill_hole_area
        self.occlusion_suppression_iou = occlusion_suppression_iou
        self.recondition_every = recondition_every
        self.recondition_bbox_iou = recondition_bbox_iou
        self.recondition_det_score = recondition_det_score
        if propagate:
            self._propagate, self._update_memory = make_tracker_fns(self.core, num_maskmem,
                                                                    max_obj_ptrs)
        self.reset()

    def reset(self):
        cfg = self.proc.cfg
        mr = cfg.mask_loss_resolution
        self.state = init_track_state(self.num_slots, (mr, mr), self.num_maskmem,
                                      self.max_obj_ptrs, self.mem_dim, cfg.d_model, self.feat_hw,
                                      device=self.device)

    def _recondition(self, prev: TrackState, st: TrackState, dm, ds, nd, iou) -> TrackState:
        # planned on the previous frame's tracks, applied to the associated
        # state, never to retired slots
        rec, det_for_slot = plan_reconditioning(
            prev, dm, ds, nd, iou, recondition_every=self.recondition_every,
            bbox_iou_thresh=self.recondition_bbox_iou,
            det_score_thresh=self.recondition_det_score)
        return apply_reconditioning(st, dm, rec & st.alive, det_for_slot)

    @torch.inference_mode()
    def step(self, frame, prompt: str) -> Dict[str, Any]:
        """Process one frame -> the live objects' obj_ids, scores and
        masks_lowres (bool at the mask resolution)."""
        self.proc.set_image(frame)
        res = self.proc.set_text_prompt(prompt, threshold=-1.0)  # keep all
        dev = self.device
        masks = torch.from_numpy(np.asarray(res["masks_lowres"], np.float32)).to(dev)
        scores = torch.from_numpy(np.asarray(res["scores"], np.float32)).to(dev)
        keep = (scores >= self.prob_threshold) & nms_masks(masks, scores, self.nms_iou)

        if self.propagate:
            feats, poss = self.proc._state["feats"], self.proc._state["poss"]
            vis = feats[-1]
            pm, ptok, _, _ = self._propagate(self.state, vis, poss[-1], feats[0], feats[1])
            # propagated masks refresh the live tracks before association
            alive = self.state.alive
            self.state = self.state._replace(
                masks=torch.where(alive[:, None, None], pm, self.state.masks).float())

        prev = self.state
        self.state = associate_and_update(self.state, masks, scores, keep,
                                          new_det_thresh=self.prob_threshold)

        # the heuristic tail: reconditioning against the previous frame's
        # tracks, then occlusion-based overlap suppression before the memory
        # encoder sees the masks
        if self.recondition_every > 0 or self.recondition_bbox_iou > 0:
            out = associate_det_trk(masks, prev.masks, det_valid=keep, trk_valid=prev.alive,
                                    det_scores=scores, new_det_thresh=self.prob_threshold)
            self.state = self._recondition(prev, self.state, masks, scores, out.new_det, out.iou)
        if self.occlusion_suppression_iou > 0:
            self.state = suppress_by_recent_occlusion(self.state, self.occlusion_suppression_iou)

        if self.propagate:
            obj_logits = torch.where(self.state.alive, 10.0, -10.0)
            self.state = self._update_memory(self.state, vis, self.state.masks, obj_logits, ptok)
        else:
            self.state = self.state._replace(frame_idx=(self.state.frame_idx + 1).to(torch.int32))

        alive = self.state.alive.cpu().numpy()
        out_masks = self.state.masks
        if self.fill_hole_area > 0:
            # output-only hole filling of this frame's newly spawned objects
            # (association and memory see the raw logits); each mask is
            # filled on its own, so only the spawned ones are labelled
            spawned = np.flatnonzero(alive & (self.state.hotstart.cpu().numpy() == 0))
            if spawned.size:
                idx = torch.from_numpy(spawned).to(dev)
                out_masks = out_masks.index_copy(
                    0, idx, fill_holes_in_mask_scores(out_masks[idx], self.fill_hole_area))
        return {
            "obj_ids": self.state.obj_ids.cpu().numpy()[alive],
            "scores": self.state.scores.cpu().numpy()[alive],
            "masks_lowres": (out_masks > 0).cpu().numpy()[alive],
        }
