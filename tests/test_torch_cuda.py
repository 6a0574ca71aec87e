"""The port's CUDA attention kernel on the card: each entry point against
its plain PyTorch version at small and ragged shapes, strided operands, and
the wrapper's input checks. These need an NVIDIA GPU with nvcc and skip
elsewhere; on a machine with a GPU run
``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerance: max |kernel - plain| <= 2e-2 * max |plain|, as in chip_smoke.py
(bf16 output against the fp32-softmax plain version: about 2.5 bf16 ulps at
the largest output)."""

import numpy as np
import pytest
import torch

from sam3_lora_tpu_torch.ops.long_attention import (
    long_attention_packed,
    long_attention_packed_plain,
    long_attention_rope_packed,
)
from sam3_lora_tpu_torch.ops.rope import compute_axial_freqs
from sam3_lora_tpu_torch.ops.window_attention import (
    window_attention_rope_packed,
    window_attention_rope_packed_plain,
)

pytestmark = pytest.mark.cuda
RTOL = 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, n, l, width):
    qkv = torch.randn(n, l, 3 * width, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv[..., :width], qkv[..., width:2 * width], qkv[..., 2 * width:]


def _assert_matches(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= RTOL * ref.float().abs().max().item(), err


def _tables(l, dh):
    ang = np.random.RandomState(l).uniform(0, 6, (l, dh // 2)).astype(np.float32)
    return torch.tensor(np.cos(ang), device="cuda"), torch.tensor(np.sin(ang), device="cuda")


@pytest.mark.parametrize("l", [1, 37, 64, 100, 576])
@pytest.mark.parametrize("p,dh", [(2, 64), (4, 32), (16, 64)])
def test_window_kernel_matches_plain(gen, l, p, dh):
    q, k, v = _qkv(gen, 3, l, p * dh)
    cos, sin = _tables(l, dh)
    before = window_attention_rope_packed.launches
    out = window_attention_rope_packed(q, k, v, dh ** -0.5, cos, sin)
    torch.cuda.synchronize()
    assert window_attention_rope_packed.launches == before + 1
    ref = window_attention_rope_packed_plain(q, k, v, dh ** -0.5, cos, sin)
    _assert_matches(out, ref)


@pytest.mark.parametrize("l", [77, 1000])
@pytest.mark.parametrize("p,dh", [(2, 64), (8, 32)])
def test_long_kernels_match_plain(gen, l, p, dh):
    q, k, v = (t.contiguous() for t in _qkv(gen, 2, l, p * dh))
    out = long_attention_packed(q, k, v, dh ** -0.5, dh)
    ref = long_attention_packed_plain(q, k, v, dh ** -0.5, dh)
    _assert_matches(out, ref)
    ang = compute_axial_freqs(dh, l, 1, scale_pos=1.0 / 3.0)
    cos, sin = (torch.tensor(f(ang), device="cuda") for f in (np.cos, np.sin))
    out = long_attention_rope_packed(q, k, v, dh ** -0.5, dh, cos, sin)
    ref = window_attention_rope_packed_plain(q, k, v, dh ** -0.5, cos, sin)
    _assert_matches(out, ref)


def test_wrapper_rejects_what_the_kernel_does_not_take(gen):
    q, k, v = (t.contiguous() for t in _qkv(gen, 1, 16, 128))
    with pytest.raises(ValueError, match="bfloat16"):
        long_attention_packed(q.float(), k.float(), v.float(), 0.1, 32)
    with pytest.raises(ValueError, match="head_dim"):
        long_attention_packed(q, k, v, 0.1, 16)
    with pytest.raises(ValueError, match="aligned"):
        long_attention_packed(q[:, :, 1:97], k[:, :, 1:97], v[:, :, 1:97], 0.1, 32)
    with pytest.raises(ValueError, match="shape"):
        long_attention_packed(q, k[:, :8], v, 0.1, 32)
