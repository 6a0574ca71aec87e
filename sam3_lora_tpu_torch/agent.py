"""MLLM-in-the-loop segmentation agent (reference ``sam3/agent/`` —
``agent_core.py:122-563``, ``client_llm.py:34-205``, ``client_sam3.py:16-138``):
the port's own copy of ``sam3_lora_tpu/agent.py``, which imports no JAX.

The reference wires an OpenAI-compatible chat client into a loop that calls
SAM3 with refined noun phrases, inspects overlaid results, and accepts or
rejects masks. Pure orchestration — the compute path is ``Sam3Processor``.

Here the LLM is an injectable callable ``llm(messages) -> str`` so any
OpenAI-compatible client (or a rule-based refiner in tests/offline
environments) plugs in; this module owns the conversation protocol:

    propose phrase -> ground -> summarize detections -> ACCEPT / REFINE <phrase>

The default ``RuleBasedRefiner`` reproduces the reference's simplest agent
behaviours (retry with article stripped, singular/plural flip, generic
fallback) without network access.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

SYSTEM_PROMPT = (
    "You are controlling a promptable image segmentation model. Given a "
    "user's concept and the model's detections (count + confidence), either "
    "reply ACCEPT to keep the current result or REFINE: <noun phrase> to "
    "try a better phrase. Keep phrases short and concrete."
)


class RuleBasedRefiner:
    """Offline fallback policy: strip articles, flip plurality, then give up."""

    def __init__(self):
        self._tried: List[str] = []

    def __call__(self, messages: List[Dict[str, str]]) -> str:
        last = messages[-1]["content"]
        m = re.search(r'phrase "(.*?)".* (\d+) detection', last)
        phrase, n_det = (m.group(1), int(m.group(2))) if m else ("object", 0)
        self._tried.append(phrase)
        if n_det > 0:
            return "ACCEPT"
        # retry heuristics in order
        candidates = []
        stripped = re.sub(r"^(a|an|the)\s+", "", phrase)
        if stripped != phrase:
            candidates.append(stripped)
        candidates.append(
            phrase[:-1] if phrase.endswith("s") else phrase + "s"
        )
        candidates.append("object")
        for c in candidates:
            if c not in self._tried:
                return f"REFINE: {c}"
        return "ACCEPT"


@dataclass
class AgentResult:
    phrase: str
    detections: Dict[str, Any]
    rounds: int
    transcript: List[Dict[str, str]] = field(default_factory=list)
    som_image: Optional["Any"] = None  # set-of-marks overlay (render_som)


def agent_inference(
    processor,
    image,
    concept: str,
    llm: Optional[Callable[[List[Dict[str, str]]], str]] = None,
    max_rounds: int = 4,
    threshold: float = 0.5,
    render_som: bool = False,
) -> AgentResult:
    """Run the propose-ground-critique loop for one concept on one image.

    ``render_som=True`` attaches a set-of-marks overlay (viz.py) of each
    round's detections to the result — the numbered-instance image the
    reference agent shows the MLLM (sam3/agent/helpers/som_utils.py).
    """
    llm = llm or RuleBasedRefiner()
    processor.set_image(image)
    messages = [{"role": "system", "content": SYSTEM_PROMPT}]
    phrase = concept
    last = None
    for rnd in range(1, max_rounds + 1):
        last = processor.set_text_prompt(phrase, threshold=threshold)
        n = last["num_detections"]
        conf = float(last["scores"].max()) if n else 0.0
        messages.append(
            {
                "role": "user",
                "content": (
                    f'Grounding the phrase "{phrase}" produced {n} detection(s) '
                    f"(best confidence {conf:.2f}, presence "
                    f"{last['presence']:.2f}). ACCEPT or REFINE?"
                ),
            }
        )
        reply = llm(messages)
        messages.append({"role": "assistant", "content": reply})
        if reply.strip().upper().startswith("ACCEPT"):
            break
        m = re.match(r"\s*REFINE\s*:\s*(.+)", reply, re.I)
        if not m:
            break
        phrase = m.group(1).strip().strip('"')
    result = AgentResult(
        phrase=phrase, detections=last, rounds=rnd, transcript=messages
    )
    if render_som and last is not None and last.get("num_detections", 0):
        import numpy as np

        from .viz import draw_set_of_marks

        masks = [np.asarray(m, bool) for m in last["masks_lowres"]]
        result.som_image = draw_set_of_marks(np.asarray(image), masks)
    return result


def make_openai_client(base_url: str, api_key: str, model: str):
    """Adapter for any OpenAI-compatible chat endpoint (reference
    client_llm.py uses the same protocol). Imported lazily; offline
    environments use RuleBasedRefiner instead."""
    def llm(messages):
        import urllib.request

        req = urllib.request.Request(
            f"{base_url.rstrip('/')}/chat/completions",
            data=json.dumps(
                {"model": model, "messages": messages, "temperature": 0.2}
            ).encode(),
            headers={
                "Authorization": f"Bearer {api_key}",
                "Content-Type": "application/json",
            },
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        return out["choices"][0]["message"]["content"]

    return llm
