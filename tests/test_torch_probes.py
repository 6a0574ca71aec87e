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
its [-30, 5] range, and a twin of the kernel's lowering of it (the clamp,
the round by 1.5 * 2^23, the exponent from the round's bits) bit for bit
against the port's over [-300, 300]; the op-rate bodies
(``probe_window_cost.py:263-272``, written again here) against ``op_plain``
at 3 passes; the op rows' bound (``window_cost.OP_MIX``: the binding unit,
the issue slot, the passes) at a fixed SM count and clock, and the SASS
reader on a written listing; each probe entry point driven on the CPU at a
small size.
"""

import collections
import functools
import importlib.util
import math
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


def fast_exp2_lowered(x: torch.Tensor) -> torch.Tensor:
    """The kernel's lowering of fast_exp2 (``csrc/attention_fwd.cuh``) in
    PyTorch: clamp x, round it by adding and subtracting 1.5 * 2^23 (one
    fp32 rounding each, to nearest even), 2^xi as the round's bits shifted
    by 23 plus 127 << 23 modulo 2^32; the polynomial as the port's."""
    s = torch.clamp(x, -126.0, 127.0) + 12582912.0
    xi = s - 12582912.0
    f = x - xi
    p = 1.0 + f * (0.6931471805599453
                   + f * (0.2402265069591007 + f * (0.05550410866482158 + f * 0.009618129107628477)))
    bits = ((s.view(torch.int32).long() << 23) + (127 << 23)) & 0xFFFFFFFF  # uint32
    return p * (bits - ((bits >> 31) << 32)).to(torch.int32).view(torch.float32)


def fast_exp2_range():
    """[-300, 300] by 2^-6, the ties k + 0.5, the clamp edges, each with its
    fp32 neighbours."""
    v = np.concatenate([np.arange(-300 * 64, 300 * 64 + 1) / 64.0, np.arange(-140, 141) + 0.5,
                        [-126.5, -126.0, -125.5, 126.5, 127.0, 127.5, -0.0, 0.0]]).astype(np.float32)
    return np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                           np.nextafter(v, np.float32(-np.inf))])


def test_fast_exp2_lowering_is_bit_for_bit():
    """The round by 1.5 * 2^23 of the clamped x is the clamp of rint(x), and
    the exponent from the round's bits is (xi + 127) << 23: the lowering
    equals the port's fast_exp2 bit for bit over [-300, 300]. Against the
    script's (XLA on the CPU): within one fp32 ulp where x is inside the
    clamp and the result normal; 0 there where ours is subnormal (XLA
    flushes); beyond the clamp, where the polynomial runs at |f| up to 174,
    within 4 ulps (the order of its multiply-adds; measured 4); the same
    infinities."""
    xs = fast_exp2_range()
    x = torch.from_numpy(xs)
    got = fast_exp2_lowered(x)
    want = pk.fast_exp2(x)
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    assert torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32))
    s = torch.clamp(x, -126.0, 127.0) + 12582912.0
    assert torch.equal(s - 12582912.0, torch.clamp(torch.round(x), -126.0, 127.0))
    ref = np.asarray(jax.jit(script("probe_window_cost").fast_exp2)(jnp.asarray(xs)))
    g = got.numpy()
    assert np.array_equal(g[~np.isfinite(ref)], ref[~np.isfinite(ref)])
    tiny = np.finfo(np.float32).tiny
    normal = np.isfinite(ref) & (np.abs(ref) >= tiny)
    inside = (xs >= -126.5) & (xs <= 127.5)
    ulps = np.abs(g - ref) / np.spacing(np.abs(ref))
    assert np.all(ulps[normal & inside] <= 1)
    assert np.all(ulps[normal & ~inside] <= 4)
    flushed = np.isfinite(ref) & ~normal
    assert np.all(ref[flushed] == 0) and np.all(np.abs(g[flushed]) < tiny)


# the bound of each op row, elements a clock an SM at its binding unit:
# (unit, clocks an element), from the mix's reasoning (window_cost.OP_MIX)
BINDING = {"add_f32": ("fp32", 1 / 128), "mul_f32": ("fp32", 1 / 128),
           "exp_f32": ("mufu", 1 / 16), "exp2_f32": ("mufu", 1 / 16),
           "fast_exp2_f32": ("issue", 11 / 128), "maxreduce_f32": ("issue", 40 / 18 / 128),
           "add_bf16": ("x2", 0.5 / 128), "exp_bf16": ("mufu", 1 / 16)}
SMS, CLOCK = 132, 1.98e9


@pytest.mark.parametrize("name", pk.OPS)
def test_op_bound_is_the_largest_unit(name):
    """At 132 SMs and 1980 MHz: the binding unit and its time, every unit's
    time no larger, the issue slot the sum of the mix (maxreduce: 2 more,
    the select of its two REDUX results on the uniform datapath), and
    passes for 1.2 ms."""
    unit, clocks = BINDING[name]
    elems = 576 * 576 * 16
    ms, got_unit = window_cost.op_bound(name, elems * 100, SMS, CLOCK)
    assert got_unit == unit
    assert ms == pytest.approx(clocks * elems * 100 / (SMS * CLOCK) * 1e3, rel=1e-12)
    times = window_cost.op_unit_ms(name, elems * 100, SMS, CLOCK)
    assert max(times.values()) == pytest.approx(ms, rel=1e-12)
    mix = window_cost.op_mix(name)
    units = sum(n for u, n in mix.items() if u != "issue")
    assert mix["issue"] == units + (2 if name == "maxreduce_f32" else 0)
    assert times["issue"] == pytest.approx(mix["issue"] / 18 / 128 * elems * 100 / (SMS * CLOCK) * 1e3)
    passes = window_cost.op_passes(name, elems, SMS, CLOCK)
    assert passes == math.ceil(1.2e-3 / (clocks * elems / (SMS * CLOCK)))
    assert window_cost.op_bound(name, elems * passes, SMS, CLOCK)[0] >= 1.2


def test_op_bound_counts_more_than_one_unit_where_the_old_did_not():
    """The corrected bound of fast_exp2, maxreduce and exp bf16 is above the
    one-row bound it replaced (the issue slot, the MUFU); add and mul f32,
    exp and exp2 f32 and add bf16 keep theirs."""
    elems = 1e9
    old = {n: window_cost.old_bound_ms(n, elems, SMS, CLOCK) for n in pk.OPS}
    new = {n: window_cost.op_bound(n, elems, SMS, CLOCK)[0] for n in pk.OPS}
    assert new["fast_exp2_f32"] == pytest.approx(old["fast_exp2_f32"] * 11 / 7)
    assert new["maxreduce_f32"] == pytest.approx(old["maxreduce_f32"] * 40 / 36)
    assert new["exp_bf16"] == pytest.approx(old["exp_bf16"] * 8)
    for n in ("add_f32", "mul_f32", "exp_f32", "exp2_f32", "add_bf16"):
        assert new[n] == pytest.approx(old[n])


# a cuobjdump -sass listing of one op kernel: a prologue, an outer loop
# holding an unrolled pass loop (2 passes) and its tail loop, and an
# out-of-line block that branches back into the pass loop
SASS = """
		Function : _ZN4sam312_GLOBAL__N_115probe_op_kernelILi0EEEvPKvPvii
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x0 */
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;  /* 0x0 */
        /*0020*/                   FADD R2, R2, 1.0000000116860974231e-07 ;  /* 0x0 */
        /*0030*/                   FADD R3, R3, 1.0000000116860974231e-07 ;  /* 0x0 */
        /*0040*/                   FADD R2, R2, 1.0000000116860974231e-07 ;  /* 0x0 */
        /*0050*/                   FADD R3, R3, 1.0000000116860974231e-07 ;  /* 0x0 */
        /*0060*/                   IADD3 R6, R6, 0x2, RZ ;       /* 0x0 */
        /*0070*/                   ISETP.GE.AND P0, PT, R6, R7, PT ;  /* 0x0 */
        /*0080*/               @!P0 BRA 0x20 ;                   /* 0x0 */
        /*0090*/                   FADD R2, R2, 1.0000000116860974231e-07 ;  /* 0x0 */
        /*00a0*/                   IADD3 R6, R6, 0x1, RZ ;       /* 0x0 */
        /*00b0*/               @P1 BRA 0x90 ;                    /* 0x0 */
        /*00c0*/                   STG.E desc[UR4][R4.64], R2 ;  /* 0x0 */
        /*00d0*/                @P2 BRA 0x10 ;                   /* 0x0 */
        /*00e0*/                   EXIT ;                        /* 0x0 */
        /*00f0*/                   REDUX.MAX.S32 UR4, R2 ;       /* 0x0 */
        /*0100*/                   BRA 0x60 ;                    /* 0x0 */
		Function : _ZN4sam312_GLOBAL__N_120attention_fwd_kernelILi64ELi6ELb0EEEvv
        /*0000*/                   BRA 0x0 ;                     /* 0x0 */
"""


def test_sass_reader_takes_the_largest_innermost_loop():
    loops = window_cost.sass_loops(SASS)
    assert list(loops) == [0]
    assert loops[0] == ["FADD"] * 4 + ["IADD3", "ISETP.GE.AND", "BRA"]
    mix = window_cost.sass_mix(loops[0], passes=2, rows=1)
    assert mix["fp32"] == 2 and mix["alu"] == 1 and mix["issue"] == 3.5
    # a move from a uniform register: MOV on the ALU, IMAD.U32 on the FMA pipe
    mix = window_cost.sass_mix(["MOV", "IMAD.U32", "IMAD.MOV.U32", "REDUX.MIN"], passes=1, rows=1)
    assert mix["alu"] == 1 and mix["imad"] == 2 and mix["redux"] == 1 and mix["issue"] == 4


def test_sass_check_flags_a_short_unit_and_a_slow_one():
    """A unit under the mix, or any unit (the binding one too) slower than
    the mix's binding unit: the issue slot up to SLOT_SLACK over, the rest
    not at all."""
    def over(name, unit, n):
        mix = window_cost.op_mix(name)
        bind = window_cost.op_bound(name, 1.0, 1, 1.0)[1]
        return f"{unit}: {n:g} over the binding {bind}'s {mix[bind]:g} in time"

    mix = window_cost.op_mix("fast_exp2_f32")  # binds on the issue slot
    sass = {u: 0.0 for u in window_cost.SASS_UNITS}
    sass.update({u: float(n) for u, n in mix.items()})
    assert window_cost.sass_check("fast_exp2_f32", sass) == []
    sass["issue"] = mix["issue"] * 1.04  # the loop's control
    assert window_cost.sass_check("fast_exp2_f32", sass) == []
    sass["issue"] = mix["issue"] * 1.06
    assert window_cost.sass_check("fast_exp2_f32", sass) == [over("fast_exp2_f32", "issue",
                                                                  sass["issue"])]
    sass.update(issue=198.0, alu=53.0, cvt=36.0)  # FRND and F2I: the conversions bind
    assert window_cost.sass_check("fast_exp2_f32", sass) == [
        "alu: 53 < 54", over("fast_exp2_f32", "cvt", 36)]
    sass = {u: 0.0 for u in window_cost.SASS_UNITS}
    sass.update(mufu=18.0, x2=18.0, alu=9.0, issue=46.0)
    assert window_cost.sass_check("exp_bf16", sass) == []
    sass["mufu"] = 36.0  # a MUFU binds: exactly the mix
    assert window_cost.sass_check("exp_bf16", sass) == [over("exp_bf16", "mufu", 36)]
    # maxreduce binds on the issue slot (40 a lane's row pass: 0.3125 clock
    # an SM); its ALU (64 a clock) may take 20 instructions, no more. The
    # kernel's SASS: the REDUX results moved by 13 IMAD.U32 and 3 MOV an
    # 8-row-pass iteration
    sass = {u: 0.0 for u in window_cost.SASS_UNITS}
    sass.update(fp32=19.0, alu=18.625, imad=1.75, redux=2.0, issue=41.75)
    assert window_cost.sass_check("maxreduce_f32", sass) == []
    sass["alu"] = 20.5
    assert window_cost.sass_check("maxreduce_f32", sass) == [over("maxreduce_f32", "alu", 20.5)]
    # a map of the bits around one REDUX: under the mix on the REDUX, over
    # the issue slot's time on the ALU and on the issue slot itself
    sass.update(alu=22.375, redux=1.0, issue=42.75)
    assert window_cost.sass_check("maxreduce_f32", sass) == [
        "redux: 1 < 2", over("maxreduce_f32", "alu", 22.375),
        over("maxreduce_f32", "issue", 42.75)]


def warp_max_twin(m: np.ndarray) -> np.float32:
    """The kernel's warp max (``csrc/probe_window.cu::warp_max``) of 32 lane
    maxima: the signed max and the unsigned min of their bits, the larger
    of the two as floats."""
    hi = m.view(np.int32).max().view(np.float32)
    lo = m.view(np.uint32).min().view(np.float32)
    return np.fmax(hi, lo)


def test_warp_max_twin_is_the_max_whatever_the_signs():
    rng = np.random.default_rng(0)
    cases = [rng.standard_normal(32), -np.abs(rng.standard_normal(32)),
             np.abs(rng.standard_normal(32)), np.r_[-np.abs(rng.standard_normal(31)), 1e-30],
             np.r_[-np.abs(rng.standard_normal(31)) - 1, -1e-30], np.r_[-np.ones(30), -0.0, 0.0],
             np.r_[-np.ones(31), -0.0], np.r_[-np.ones(31), -np.inf], np.r_[np.ones(31), np.inf],
             np.r_[-np.ones(31), -1e38]]
    cases += [rng.standard_normal(32) * 10.0 ** rng.uniform(-30, 30, 32) for _ in range(200)]
    cases += [-np.abs(rng.standard_normal(32)) * 10.0 ** rng.uniform(-30, 30, 32)
              for _ in range(200)]
    for c in cases:
        m = np.asarray(c, np.float32)
        got = warp_max_twin(m)
        assert got == m.max() and got in m, m
    # every lane negative: the signed max of the bits alone is the most negative
    m = -np.abs(rng.standard_normal(32)).astype(np.float32) - 0.5
    assert m.view(np.int32).max().view(np.float32) == m.min()


def test_op_moving_input_moves_and_shows_a_wrong_max():
    """op_plain changes every row of the moving input each pass (maxreduce:
    the rows with a positive max; add_bf16: all), where it leaves the
    script's input as it is; and a max over half the row, the max of the
    raw bits as signed integers, or the max by magnitude gives other bits."""
    g = torch.Generator().manual_seed(0)
    x = window_cost.op_moving_input(g, "maxreduce_f32", 577)
    y = pk.op_plain(x, "maxreduce_f32", 1)
    kind = torch.arange(577) % 3
    moved = (y != x).any(dim=1)
    assert moved[kind < 2].all()
    big = x.abs().amax(dim=1)
    assert ((big >= 10) & (big <= 1000)).all()
    assert (x.amax(dim=1)[kind == 2] < 0).all()
    assert len(set((torch.arange(577) * 37 % 576 % 32).tolist())) == 32
    for wrong in (x[:, :288].amax(dim=1, keepdim=True),
                  x.view(torch.int32).amax(dim=1, keepdim=True).view(torch.float32),
                  x.gather(1, x.abs().argmax(dim=1, keepdim=True))):
        assert not torch.equal(x + wrong * 1e-9, y)
    x = window_cost.op_moving_input(g, "add_bf16", 577)
    assert (x >= 0).all() and (x <= 0.05).all()  # bf16 of [0, 0.05)
    assert (pk.op_plain(x, "add_bf16", 1) != x).all()
    for name in ("maxreduce_f32", "add_bf16"):
        x = window_cost.op_input(g, name, 1)
        assert torch.equal(pk.op_plain(x, name, 1), x)


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
