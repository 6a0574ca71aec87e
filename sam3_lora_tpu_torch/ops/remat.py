"""Named saves across a checkpoint region: the port's counterpart of JAX's
``checkpoint_name`` and ``save_only_these_names`` policy.

``torch.utils.checkpoint`` saves a region's inputs and replays the whole
region in the backward. The JAX remat policies keep some tensors by name
instead of replaying the work that made them: the attention output
(``"vit_attn_out"``, ``"enc_attn_out"``), so that no attention forward runs
again. PyTorch's selective checkpointing sees only operators that go through
its dispatcher, and the attention kernels are launched through ``ctypes``
from inside ``autograd.Function``s, so the port marks them itself:

* a call site wraps the computation in ``tag(name)``, as JAX tags its result
  with ``checkpoint_name``;
* ``models/layers.py::checkpoint`` runs its region inside a ``Region`` that
  keeps some names;
* the kernel wrappers compute through ``kept(compute)``: in the region's
  first pass it stores the result of a tagged call whose name the region
  keeps; in the backward's replay it hands the stored results back, in
  order, and ``compute`` does not run. The attention Functions still record
  their backward nodes, which take the kept output and log-sum-exp.

A kept tensor lives until the region's backward frees the replay's closure.

A replay runs until the region's last saved tensor is recomputed. Two kinds
of saved tensors would pull it through work whose value no gradient reads:

* a dropout or drop-path mask drawn after a frozen product: ``held()`` saves
  the tensors of the operators inside it as they are, outside the region's
  saving, so the replay need not redraw the mask (a mask is one byte an
  element, or one per sample for drop-path);
* a tensor that an ``autograd.Function`` saves: torch packs it after the
  Function's forward has run, so a region that ends in the Function replays
  its product. ``SaveFirst`` saves such tensors before the product instead
  (``ops/quant.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List

import torch

_TAGS: List[str] = []
_REGIONS: List["Region"] = []


class Region:
    """The results one checkpoint region keeps, by the names in ``names``."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self.kept: list = []
        self.replaying = False
        self.pos = 0

    @contextlib.contextmanager
    def active(self, replay: bool):
        """Run the region's first pass (``replay`` False) or a replay."""
        self.replaying, self.pos = replay, 0
        _REGIONS.append(self)
        try:
            yield
        finally:
            _REGIONS.pop()


@contextlib.contextmanager
def tag(name: str):
    """Name what the kernel calls inside compute, for the regions that keep
    ``name``."""
    _TAGS.append(name)
    try:
        yield
    finally:
        _TAGS.pop()


def _detached(out):
    if isinstance(out, tuple):
        return tuple(None if t is None else t.detach() for t in out)
    return out.detach()


def kept(compute: Callable):
    """``compute()``, or in a replay the result the region's first pass kept
    for this call (see the module docstring)."""
    region = _REGIONS[-1] if _REGIONS else None
    if region is None or not _TAGS or _TAGS[-1] not in region.names:
        return compute()
    if region.replaying:
        out = region.kept[region.pos]
        region.pos += 1
        return _detached(out)
    out = compute()
    region.kept.append(_detached(out))
    return out


def _same(t):
    return t


@contextlib.contextmanager
def held():
    """Inside, operators save their tensors for the backward as they are, past
    any checkpoint region: the region's replay does not recompute them."""
    with torch.autograd.graph.saved_tensors_hooks(_same, _same):
        yield


class SaveFirst(torch.autograd.Function):
    """Save tensors before a product that needs them in its backward: apply
    to them before the product, pass the token it returns to the product's
    Function, which reads them back in its backward through ``saved(token)``.
    The token is an empty tensor; this Function's own backward returns no
    gradient (the product's Function returns those of the saved tensors)."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.n = len(tensors)
        return tensors[0].new_empty(0)

    @staticmethod
    def backward(ctx, _):
        return (None,) * ctx.n


def saved(token: torch.Tensor):
    """The tensors ``SaveFirst`` saved for ``token``."""
    return token.grad_fn.saved_tensors
