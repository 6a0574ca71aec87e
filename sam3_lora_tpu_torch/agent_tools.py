"""Tool-calling MLLM agent protocol (reference ``sam3/agent/agent_core.py``):
the port's own copy of ``sam3_lora_tpu/agent_tools.py``, which imports no JAX.

The reference drives a Qwen-style MLLM through a ``<tool>{json}</tool>``
protocol with four tools — ``segment_phrase``, ``examine_each_mask``,
``select_masks_and_return``, ``report_no_mask`` — passing every intermediate
result through JSON files + PNGs on disk (agent_core.py:120-563). This
re-design keeps the whole conversation in memory: masks live as numpy
arrays attached to the session, images go into messages as arrays (an
OpenAI-style client can base64 them at the transport layer), and the SAM3
call is a :class:`~sam3_lora_tpu_torch.processor.Sam3Processor` invocation on the
cached backbone — no server round-trip.

Protocol invariants preserved from the reference:

* exactly one tool call per assistant turn, wrapped in ``<tool>...</tool>``;
* every ``segment_phrase`` call invalidates all previously generated masks
  (only the latest generation is selectable, :73-74 of the system prompt);
* duplicate ``text_prompt``s are rejected with a corrective user message
  listing all used prompts (agent_core.py:228-247);
* ``examine_each_mask`` runs an independent per-mask Accept/Reject
  sub-conversation with its own system prompt and a zoomed crop
  (agent_core.py:296-381, ``<verdict>`` tag);
* message history is pruned between ``segment_phrase`` rounds down to the
  preamble + the latest segment_phrase turn, with a warning listing
  exhausted prompts (``_prune_messages_for_next_round``, :54-119);
* the final answer re-indexes ``final_answer_masks`` (1-based, deduped,
  invalid indices dropped — agent_core.py:455-470).
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "load_system_prompt",
    "AGENT_SYSTEM_PROMPT",
    "MASK_CHECK_SYSTEM_PROMPT",
    "ToolCall",
    "ToolAgentResult",
    "ScriptedLLM",
    "tool_agent_inference",
]


def load_system_prompt(name: str) -> str:
    """Load a prompt from the corpus (``assets/agent_prompts/<name>.txt``,
    the analogue of the reference's ``sam3/agent/system_prompts/``). Raises
    FileNotFoundError for unknown names."""
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets", "agent_prompts", f"{name}.txt",
    )
    with open(path, "r") as f:
        return f.read()


# The reference ships a ~66 KB prompt corpus (system_prompts/*.txt); ours
# lives in assets/agent_prompts/ (load_system_prompt). The compact fallback
# below states the same behavioural contract and keeps the module
# self-contained; production runs use the corpus (or pass system_prompt=).
AGENT_SYSTEM_PROMPT = """\
You are a visual grounding assistant that controls a promptable segmentation
model through tools. The user gives a referring expression or a question
about an image; your job is to return the segmentation mask(s) of exactly
the object(s) the user means.

Rules of engagement:
- Call exactly ONE tool per turn, as <tool>{"name": ..., "parameters": ...}</tool>,
  then stop and wait for the result.
- After each segment_phrase call, all masks are RE-numbered and re-rendered
  on the newest image; numbers from older turns are void. You may only refer
  to masks on the most recent image.
- Ground the PRIMARY object of the query, never a helper object or a part
  ("a person holding a cup" -> ground the person, not the cup or the hand).
- segment_phrase wants a short, simple noun phrase (optionally with a color
  adjective). No counts, no written text, no relations, no comparatives:
  prefer "dog" over "the dog lying down", then narrow down by selecting
  masks. If a phrase yields nothing, retry with a more general or creative
  phrase; never reuse a phrase that was already tried.
- If the query is noisy or slightly wrong, infer what the user most
  plausibly means from the image and ground that.
- When several masks overlap or are tiny, use examine_each_mask to judge
  each one in isolation before selecting.
- Finish with select_masks_and_return listing the 1-based numbers of the
  correct mask(s) from the MOST RECENT image, or report_no_mask if the
  target truly is not in the image.

Tools:
1. segment_phrase {"text_prompt": str} — grounds all instances of a simple
   noun phrase; renders and numbers the resulting masks; deletes all masks
   from previous rounds.
2. examine_each_mask {} — shows each current mask alone plus a zoomed-in
   crop to an independent checker that accepts or rejects it; the surviving
   masks are re-rendered and re-numbered.
3. select_masks_and_return {"final_answer_masks": [int, ...]} — returns the
   selected masks as the final answer.
4. report_no_mask {} — declares that no mask in the image matches the query.
"""

MASK_CHECK_SYSTEM_PROMPT = """\
You check ONE candidate segmentation mask against a user's query. You see
the raw image, the query, the image with the candidate mask rendered, and a
zoomed-in crop of the mask region. Decide whether this mask covers exactly
one correct target instance (whole object, correct category, matches the
query). Reply with your reasoning followed by <verdict>Accept</verdict> or
<verdict>Reject</verdict> — exactly one of the two."""


@dataclass
class ToolCall:
    name: str
    parameters: Dict[str, Any]


@dataclass
class ToolAgentResult:
    masks: List[np.ndarray]  # final selected (H, W) bool masks
    boxes: List[List[float]]  # matching xyxy boxes
    scores: List[float]
    no_mask: bool  # report_no_mask was the final action
    rounds: int  # LLM generations consumed
    used_prompts: List[str]
    transcript: List[Dict[str, Any]] = field(default_factory=list)


def parse_tool_call(text: str) -> ToolCall:
    """Extract the single ``<tool>{json}</tool>`` call (agent_core.py:201-215
    semantics, incl. the stray-brace cleanup)."""
    if "<tool>" not in text:
        raise ValueError(f"no <tool> tag in: {text[:200]!r}")
    payload = text.split("<tool>")[-1].split("</tool>")[0].strip()
    payload = payload.replace("}}}", "}}")
    call = json.loads(payload)
    return ToolCall(name=call["name"], parameters=call.get("parameters", {}))


class ScriptedLLM:
    """Offline stand-in for the LLM: replays a fixed list of assistant turns (the
    reference tests against a live Qwen server; tests here must not)."""

    def __init__(self, turns: List[str]):
        self.turns = list(turns)
        self.calls: List[List[Dict[str, Any]]] = []

    def __call__(self, messages: List[Dict[str, Any]]) -> str:
        self.calls.append([dict(m, content="...") for m in messages])
        if not self.turns:
            return '<tool>{"name": "report_no_mask", "parameters": {}}</tool>'
        return self.turns.pop(0)


def _upsample_masks(
    masks_lowres: np.ndarray, h: int, w: int
) -> List[np.ndarray]:
    """(N, h', w') bool low-res mask logits-thresholds -> N full-res bools
    (nearest; the agent tier only needs render-accurate masks)."""
    from PIL import Image as PILImage

    out = []
    for m in np.asarray(masks_lowres):
        im = PILImage.fromarray(np.asarray(m, np.uint8) * 255)
        out.append(np.asarray(im.resize((w, h), PILImage.NEAREST)) > 127)
    return out


def _render_som(image: np.ndarray, masks: List[np.ndarray]) -> np.ndarray:
    from .viz import draw_set_of_marks

    return draw_set_of_marks(np.asarray(image), [np.asarray(m, bool) for m in masks])


def _prune_messages(
    messages: List[Dict[str, Any]],
    used_prompts: List[str],
    latest_prompt: str,
    preamble: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Keep preamble + the latest assistant segment_phrase turn onward; fold
    the exhausted-prompts warning into the preamble (agent_core.py:54-119)."""
    start = None
    for idx in range(len(messages) - 1, len(preamble) - 1, -1):
        msg = messages[idx]
        if msg.get("role") == "assistant" and "segment_phrase" in str(
            msg.get("content", "")
        ) and "<tool>" in str(msg.get("content", "")):
            start = idx
            break
    tail = messages[start:] if start is not None else []
    previously_used = [p for p in used_prompts if p != latest_prompt]
    head = [dict(m) for m in preamble]
    if tail and previously_used:
        head[-1] = dict(
            head[-1],
            content=head[-1]["content"]
            + (
                f" Previously tried segment_phrase text_prompts (all "
                f"unsatisfactory, do NOT reuse): {previously_used}."
            ),
        )
    return head + tail


def tool_agent_inference(
    processor,
    image,
    query: str,
    llm: Callable[[List[Dict[str, Any]]], str],
    max_generations: int = 12,
    threshold: float = 0.5,
    system_prompt: str = AGENT_SYSTEM_PROMPT,
    check_system_prompt: str = MASK_CHECK_SYSTEM_PROMPT,
) -> ToolAgentResult:
    """Run the full tool-calling loop for one (image, query) pair.

    ``llm(messages) -> str`` is any chat callable (``agent.make_openai_client``
    or :class:`ScriptedLLM`). Message contents are plain strings; images are
    attached as ``{"role": "user", "content": str, "image": np.ndarray}``
    entries so a transport adapter can encode them.
    """
    image = np.asarray(image)
    processor.set_image(image)

    preamble = [
        {"role": "system", "content": system_prompt},
        {
            "role": "user",
            "content": (
                "The attached image is the raw input image. The initial user "
                f"input query is: '{query}'."
            ),
            "image": image,
        },
    ]
    messages = [dict(m) for m in preamble]

    used_prompts: List[str] = []
    cur_masks: List[np.ndarray] = []
    cur_boxes: List[List[float]] = []
    cur_scores: List[float] = []
    have_grounded = False
    gens = 0

    def _result(no_mask: bool) -> ToolAgentResult:
        return ToolAgentResult(
            masks=cur_masks,
            boxes=cur_boxes,
            scores=cur_scores,
            no_mask=no_mask,
            rounds=gens,
            used_prompts=used_prompts,
            transcript=messages,
        )

    while gens < max_generations:
        reply = llm(messages)
        gens += 1
        call = parse_tool_call(reply)
        messages.append({"role": "assistant", "content": reply})

        if not have_grounded and call.name not in ("segment_phrase", "report_no_mask"):
            raise ValueError(
                f"first tool call must be segment_phrase/report_no_mask, got {call.name}"
            )

        if call.name == "report_no_mask":
            cur_masks, cur_boxes, cur_scores = [], [], []
            return _result(no_mask=True)

        if call.name == "segment_phrase":
            phrase = call.parameters["text_prompt"]
            if phrase in used_prompts:
                messages.append(
                    {
                        "role": "user",
                        "content": (
                            f"You already used '{phrase}' as a text_prompt; it "
                            "may not be reused. Call segment_phrase with a "
                            "different, perhaps more general phrase. Never use "
                            f"any of: {used_prompts}."
                        ),
                    }
                )
                continue
            used_prompts.append(phrase)
            out = processor.set_text_prompt(phrase, threshold=threshold)
            n = int(out["num_detections"])
            h, w = image.shape[:2]
            cur_masks = _upsample_masks(out["masks_lowres"][:n], h, w)
            cur_boxes = [list(map(float, b)) for b in out["boxes"][:n]]
            cur_scores = [float(s) for s in out["scores"][:n]]
            have_grounded = True
            messages = _prune_messages(messages, used_prompts, phrase, preamble)
            if n == 0:
                messages.append(
                    {
                        "role": "user",
                        "content": (
                            f"segment_phrase produced no masks for "
                            f"'{phrase}'. Call it again with a different, more "
                            f"general or more creative simple noun phrase. The "
                            f"original user query was '{query}'."
                        ),
                    }
                )
            else:
                messages.append(
                    {
                        "role": "user",
                        "content": (
                            f"segment_phrase generated {n} available mask(s), "
                            "rendered and numbered on the attached image. "
                            "Analyze them against the raw image and the "
                            f"original user query '{query}', then act."
                        ),
                        "image": _render_som(image, cur_masks),
                    }
                )
            continue

        if call.name == "examine_each_mask":
            if not cur_masks:
                raise ValueError("examine_each_mask with no current masks")
            from .viz import overlay_masks, zoom_to_box

            keep: List[int] = []
            for i, (m, b) in enumerate(zip(cur_masks, cur_boxes)):
                solo = overlay_masks(image, [m])
                zoom, _window = zoom_to_box(image, b)
                check_messages = [
                    {"role": "system", "content": check_system_prompt},
                    {
                        "role": "user",
                        "content": (
                            f"The initial user input query is: '{query}'. "
                            "Attached: the raw image, the image with the "
                            "candidate mask rendered, and the zoomed-in mask."
                        ),
                        "image": image,
                    },
                    {"role": "user", "content": "Candidate mask:", "image": solo},
                    {"role": "user", "content": "Zoomed-in mask:", "image": zoom},
                ]
                verdict_text = llm(check_messages)
                gens += 1
                verdict = (
                    verdict_text.split("<verdict>")[-1]
                    .split("</verdict>")[0]
                    .strip()
                )
                if verdict == "Accept":
                    keep.append(i)
                elif verdict != "Reject":
                    raise ValueError(f"bad verdict: {verdict_text[:120]!r}")
            cur_masks = [cur_masks[i] for i in keep]
            cur_boxes = [cur_boxes[i] for i in keep]
            cur_scores = [cur_scores[i] for i in keep]
            if not cur_masks:
                messages.append(
                    {
                        "role": "user",
                        "content": (
                            "examine_each_mask rejected every mask. Call "
                            "segment_phrase again with a different, more "
                            "general or more creative phrase. The original "
                            f"user query was '{query}'."
                        ),
                    }
                )
            else:
                messages.append(
                    {
                        "role": "user",
                        "content": (
                            f"After examine_each_mask, {len(cur_masks)} mask(s) "
                            "remain, re-rendered and re-numbered on the "
                            "attached image. Analyze them against the original "
                            f"user query '{query}', then act."
                        ),
                        "image": _render_som(image, cur_masks),
                    }
                )
            continue

        if call.name == "select_masks_and_return":
            sel = call.parameters["final_answer_masks"]
            valid = set(range(1, len(cur_masks) + 1))
            picked = sorted({int(i) for i in sel} & valid)
            cur_masks = [cur_masks[i - 1] for i in picked]
            cur_boxes = [cur_boxes[i - 1] for i in picked]
            cur_scores = [cur_scores[i - 1] for i in picked]
            return _result(no_mask=False)

        raise ValueError(f"unknown tool: {call.name}")

    # generation budget exhausted: return whatever is currently grounded
    return _result(no_mask=not cur_masks)
