"""The idle and roofline arithmetic on a written trace."""

import pytest

from benchmark import harness, trace


def test_covered_gaps_and_breakdown():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1"), (6.0, 6.5, "copy")]
    spans = [(0.0, 10.0, "request"), (2.0, 3.0, "data_wait"), (4.0, 6.0, "prompt")]
    assert trace.covered(dev) == pytest.approx(3.5)
    assert trace.gaps(dev, (0.0, 8.0)) == [(2.0, 3.0), (4.0, 6.0), (6.5, 8.0)]
    b = trace.breakdown(dev, spans, (0.0, 8.0))
    assert b["device_ops"][0] == ["k1", 2.0]
    assert b["idle_gaps"] == [["prompt", 2.0], ["request", 1.5], ["data_wait", 1.0]]
    assert trace.device_seconds(dev, ("k1", "copy")) == pytest.approx(2.5)


def ctx(unit):
    return {"unit": unit, "window_s": 10.0, "busy_s": 7.5,
            "device": [(0.0, 2.0, "void attention_fwd_kernel<64>"), (2.0, 3.0, "dq_kernel"),
                       (3.0, 7.5, "void sam3::sm90::gemm_kernel<(anonymous namespace)::S8Scaled>")],
            "spans": [], "data_wait_s": [0.01, 0.03],
            "work": {"flops": 989e12 * 2.0, "attn": (0, 0, 1.5), "int8": (0, 0, 0.9)}}


def test_readers():
    assert harness.reader("idle_share.train")(ctx("train")) == pytest.approx(25.0)
    assert harness.reader("idle_share.serve")(ctx("train")) is None
    assert harness.reader("train_mfu")(ctx("train")) == pytest.approx(20.0)
    assert harness.reader("serve_mfu")(ctx("request")) == pytest.approx(20.0)
    assert harness.reader("attn_roofline.train")(ctx("train")) == pytest.approx(50.0)
    assert harness.reader("attn_roofline.serve")(ctx("request")) == pytest.approx(75.0)
    assert harness.reader("gemm_int8_roofline.train")(ctx("train")) == pytest.approx(20.0)
    assert harness.reader("data_wait_ms.train")(ctx("train")) == pytest.approx(20.0)
    empty = dict(ctx("train"), device=[])
    assert harness.reader("attn_roofline.train")(empty) is None  # nothing to read: no 0
