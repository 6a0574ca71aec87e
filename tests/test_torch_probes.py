"""The window-kernel probes of the port (``ops/probe_kernels.py``,
``sam3_lora_tpu_torch/probes``) against the JAX probe scripts, on the CPU.

Each Pallas kernel body of ``scripts/probe_window_cost.py`` (the stage
ladder), ``scripts/probe_dma_floor.py`` (the block sweep) and
``scripts/probe_packed.py`` (the head-pair-packed forward and backward) runs
through ``pl.pallas_call(..., interpret=True)`` with the script's own block
shapes, at 2 head groups or pairs of 576 tokens x 64, and is held against the
port's plain version on the same numpy-seeded bf16 inputs: max |JAX - port|
<= 1e-2 * max |JAX|, one bf16 ulp of the largest output plus the order of
summation. Measured: copies bit for bit; the other forward bodies 0.09-0.24
of the bound; the backward's gradients 0.20 (dq), 0.63 (dk) and 0.37 (dv).

Also: the port's ``fast_exp2`` against the script's within one fp32 ulp on
its [-30, 5] range; the op-rate bodies (``probe_window_cost.py:263-272``,
written again here) against ``op_plain`` at 3 passes; each probe entry point
driven on the CPU at a small size.
"""

import collections
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sam3_lora_tpu_torch.ops import probe_kernels as pk
from sam3_lora_tpu_torch import probes
from sam3_lora_tpu_torch.probes import dma_floor, packed, pair_view, window_cost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D = 576, 64
SCALE = D ** -0.5
RTOL = 1e-2


@functools.lru_cache(maxsize=None)
def script(name):
    """The JAX probe script ``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def inputs(shape, count=3, seed=0):
    """``count`` bf16 arrays of ``shape`` from one numpy seed, as (JAX, torch)."""
    rng = np.random.RandomState(seed)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]
    return ([jnp.asarray(x).astype(jnp.bfloat16) for x in xs],
            [torch.from_numpy(x).to(torch.bfloat16) for x in xs])


def run_pallas(body, args, block, n_out=1, scale=True):
    """The script's pallas_call of ``body`` over ``args`` with the block
    ``block`` along the leading axis, in interpret mode."""
    shape = args[0].shape
    nd = len(shape)
    spec = pl.BlockSpec(block, lambda i: (i,) + (0,) * (nd - 1), memory_space=pltpu.VMEM)
    out_shape = [jax.ShapeDtypeStruct(shape, jnp.bfloat16)] * n_out
    call = pl.pallas_call(
        functools.partial(body, scale=SCALE) if scale else body,
        out_shape=out_shape if n_out > 1 else out_shape[0],
        grid=(shape[0] // block[0],),
        in_specs=[spec] * len(args),
        out_specs=[spec] * n_out if n_out > 1 else spec,
        interpret=True,
    )
    out = call(*args)
    return [np.asarray(o.astype(jnp.float32)) for o in (out if n_out > 1 else [out])]


def assert_close(jax_out, port_out, rtol=RTOL):
    port = port_out.float().numpy()
    if rtol == 0:
        np.testing.assert_array_equal(port, jax_out)
        return
    err = np.abs(port - jax_out).max()
    assert err <= rtol * np.abs(jax_out).max(), (err, rtol * np.abs(jax_out).max())


# (script body, port stage, pair form) of the stage ladder
LADDER = [("k_copy", "copy", False), ("k_qk_pv", "qk_pv", False),
          ("k_qk_exp_pv", "qk_exp_pv", False), ("k_qk_exp2_pv", "qk_exp2_pv", False),
          ("k_qk_fexp_pv", "qk_fexp_pv", False), ("k_qk_mexp_pv", "qk_mexp_pv", False),
          ("k_full", "full", False), ("k_full_fexp", "full_fexp", False),
          ("k_full_bf16s", "full_bf16s", False), ("k_qk_pv_packed", "qk_pv", True),
          ("k_full_packed", "full", True)]


@pytest.mark.parametrize("body,stage,pair", LADDER, ids=[b for b, _, _ in LADDER])
def test_window_cost_stage_bodies(body, stage, pair):
    """``run_stage``'s call: (2, G=2, L, D), one head group per program."""
    mod = script("probe_window_cost")
    (jq, jk, jv), (tq, tk, tv) = inputs((2, 2, L, D))
    (want,) = run_pallas(getattr(mod, body), (jq, jk, jv), (1, 2, L, D))
    got = pk.stage(tq, tk, tv, stage, SCALE, pair=pair)
    assert_close(want, got, 0 if stage == "copy" else RTOL)


# (script body, block, logical shape, port stage, pair form, work per CTA)
SWEEP = [
    ("k_copy", (1, 2, L, D), (2, 2, L, D), "copy", False, 2),
    ("k_copy", (2, 2, L, D), (2, 2, L, D), "copy", False, 4),
    ("k_copy", (1, L, 128), (2, L, 128), "copy", True, 1),
    ("k_full", (1, 2, L, D), (2, 2, L, D), "full", False, 2),
    ("k_full", (2, 2, L, D), (2, 2, L, D), "full", False, 4),
]


@pytest.mark.parametrize("body,block,shape,stage,pair,wpc", SWEEP,
                         ids=[f"{s[0]}-{'x'.join(map(str, s[1]))}" for s in SWEEP])
def test_dma_floor_block_sweep_bodies(body, block, shape, stage, pair, wpc):
    mod = script("probe_dma_floor")
    (jq, jk, jv), (tq, tk, tv) = inputs(shape)
    (want,) = run_pallas(getattr(mod, body), (jq, jk, jv), block, scale=body == "k_full")
    views = [pair_view(t) if pair else t for t in (tq, tk, tv)]
    got = pk.stage(*views, stage, SCALE, pair=pair, wpc=wpc)
    if pair:
        got = got.transpose(1, 2).reshape(shape)
    assert_close(want, got, 0 if stage == "copy" else RTOL)


# (script body, window-pairs per program, port stage, pair form, work per CTA)
PACKED = [("k_copy", 1, "copy", True, 1), ("k_slice", 1, "full", False, 2),
          ("k_slice", 2, "full", False, 4), ("k_blockdiag", 1, "full", True, 1)]


@pytest.mark.parametrize("body,wpp,stage,pair,wpc", PACKED,
                         ids=[f"{b}-wpp{w}" for b, w, _, _, _ in PACKED])
def test_packed_forward_bodies(body, wpp, stage, pair, wpc):
    mod = script("probe_packed")
    (jq, jk, jv), (tq, tk, tv) = inputs((2, L, 2 * D))
    (want,) = run_pallas(getattr(mod, body), (jq, jk, jv), (wpp, L, 2 * D),
                         scale=body != "k_copy")
    got = pk.stage(*(pair_view(t) for t in (tq, tk, tv)), stage, SCALE, pair=pair, wpc=wpc)
    assert_close(want, got.transpose(1, 2).reshape(2, L, 2 * D),
                 0 if stage == "copy" else RTOL)


def test_packed_backward_body():
    """``k_bwd_slice`` (4 inputs, 3 outputs) against ``pair_bwd`` on the CPU."""
    mod = script("probe_packed")
    js, ts = inputs((2, L, 2 * D), count=4)
    want = run_pallas(mod.k_bwd_slice, js, (1, L, 2 * D), n_out=3)
    q, k, v, do = (pair_view(t) for t in ts)
    got = pk.pair_bwd(q, k, v, None, None, do, SCALE)
    for w, g in zip(want, got):
        assert_close(w, g.transpose(1, 2).reshape(2, L, 2 * D))


def test_fast_exp2_matches_the_script():
    mod = script("probe_window_cost")
    xs = np.linspace(-30.0, 5.0, 4097, dtype=np.float32)
    want = np.asarray(jax.jit(mod.fast_exp2)(jnp.asarray(xs)))
    got = pk.fast_exp2(torch.from_numpy(xs)).numpy()
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))


# the vpu_probe bodies of probe_window_cost.py:263-272, as the script writes them
def _fast_exp2(y):
    return script("probe_window_cost").fast_exp2(y)


OP_BODIES = {
    "add_f32": lambda y: y + 1e-7,
    "mul_f32": lambda y: y * 1.0000001,
    "exp_f32": lambda y: jnp.exp(-y) + 0.5,
    "exp2_f32": lambda y: jnp.exp2(-y) + 0.5,
    "fast_exp2_f32": lambda y: _fast_exp2(-y) + 0.5,
    "maxreduce_f32": lambda y: y + jnp.max(y, axis=-1, keepdims=True) * 1e-9,
    "add_bf16": lambda y: y + jnp.bfloat16(1e-3),
    "exp_bf16": lambda y: jnp.exp(-y) + jnp.bfloat16(0.5),
}
# max |JAX - port|: fp32 1e-5 * max |JAX| (libm exp against XLA's, an ulp or
# two a pass); bf16 in ulps of max |JAX|: add one, exp two (its port form
# rounds -y * log2(e) to bf16 before its 2^x, as the kernel's packed form
# does, where the JAX body rounds exp(-y); measured 2 ulps at 3 passes)
BF16_ULPS = {"add_bf16": 1, "exp_bf16": 2}
PASSES = 3


@pytest.mark.parametrize("name", pk.OPS)
def test_op_rate_bodies(name):
    body = OP_BODIES[name]
    rng = np.random.RandomState(0)
    x32 = np.abs(rng.standard_normal((L, L))).astype(np.float32) + 0.5
    dtype = jnp.bfloat16 if name.endswith("bf16") else jnp.float32
    jx = jnp.asarray(x32).astype(dtype)

    def kern(x_ref, o_ref):
        o_ref[...] = jax.lax.fori_loop(0, PASSES, lambda i, y: body(y), x_ref[...])

    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(jx.shape, jx.dtype),
                          interpret=True)(jx)
    want = np.asarray(want.astype(jnp.float32))
    got = pk.op_rate(torch.from_numpy(x32).to(pk.op_dtype(name)), name, PASSES).float().numpy()
    err = np.abs(got - want).max()
    top = np.abs(want).max()
    if name in BF16_ULPS:
        limit = BF16_ULPS[name] * 2.0 ** (np.floor(np.log2(top)) - 7)
    else:
        limit = 1e-5 * top
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("module", [window_cost, dma_floor, packed],
                         ids=["window_cost", "dma_floor", "packed"])
def test_probe_entry_points_on_cpu(module, capsys, monkeypatch):
    """Each probe's command line with ``--device cpu`` at batch 1, an image
    cut to one window (16 head-windows): every row prints, and every
    comparison (plain against plain here) passes."""
    monkeypatch.setattr(probes, "WINDOWS_PER_IMAGE", 1)
    rows = module.main(["--device", "cpu", "--batch", "1", "--reps", "1"])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "FAILED" not in out
    assert rows and all(f"{r['name']} " in out for r in rows)


def test_stage_row_holds_its_timed_output_against_plain(monkeypatch):
    """A row compares the output of its timed calls with the plain
    version's, and counts the launches of those calls only: a kernel that
    writes zeros fails its row."""
    (_, _, _), (q, k, v) = inputs((2, 2, L, D))

    def zeros(q, k, v, name, scale, pair=False, wpc=1, o=None):
        zeros.launches[pk.variant(name, pair, wpc)] += 1
        return o.zero_()

    zeros.launches = collections.Counter({"full_wpc1": 5})
    monkeypatch.setattr(pk, "stage", zeros)
    r = probes.stage_row("full", "here", q, k, v, "full", 2, "cpu")
    assert not r["ok"] and r["max_abs_err"] > r["limit"] > 0
    assert r["launches"] == 3  # one warm-up and two timed calls


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 2, L, D, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        pk.stage(q, q, q, "full", SCALE)
    with pytest.raises(ValueError, match="no kernel"):
        pk.op_rate(torch.zeros(4, pk.OP_COLS, device="meta"), "add_f32", 1)


# ---- the step profile (measure.profile_step), read by chip_smoke's
# bench-train phase and probes/step_ab.py

def test_covered_is_the_union_of_intervals():
    from sam3_lora_tpu_torch.measure import covered

    assert covered([]) == 0.0
    assert covered([(0.0, 2.0, "a"), (1.0, 3.0, "b"), (5.0, 6.0, "c")]) == 4.0
    assert covered([(0.0, 10.0, "a"), (2.0, 3.0, "b"), (4.0, 12.0, "c")]) == 12.0


def test_profile_step_refuses_a_trace_without_device_time():
    """On a host without a card the trace holds no kernel: the profile
    fails rather than report a device share of 0."""
    from sam3_lora_tpu_torch.measure import profile_step

    with pytest.raises(RuntimeError, match="no device time"):
        profile_step(lambda: torch.ones(8, 8) @ torch.ones(8, 8))


def test_paired_ms_times_both_in_turns():
    from sam3_lora_tpu_torch.measure import paired_ms

    calls = []
    ta, tb = paired_ms(lambda: calls.append("a"), lambda: calls.append("b"), 3, "cpu")
    assert calls == ["a", "b"] * 4 and ta >= 0.0 and tb >= 0.0
