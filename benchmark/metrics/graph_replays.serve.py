"""CUDA graph replays a request or prompt (the program's counter
``graph_replays``): two a ``predict`` (the image backbone, the grounding),
one a ``set_image`` and one a ``set_text_prompt``. None for a program
without the graph cache (no ``sam3_lora_tpu_torch.graphs``)."""

import importlib.util

from benchmark.program import counter_per_unit


def read(ctx):
    if importlib.util.find_spec("sam3_lora_tpu_torch.graphs") is None:
        return None
    return counter_per_unit(ctx, ("request", "prompt"), "graph_replays")
