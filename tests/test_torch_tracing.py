"""Tracer tests for the port: the analogues of ``tests/test_tracing.py``
(in-step recording, saturation, host/device merge, analysis layers), and
the device recorder held against the reference's: the same sequence of
``record`` / ``tick`` / ``record_host`` calls drains to the reference's
rows exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracing as JT
from repro_torch.core.analysis import layer1_decode, layer2_per_core, \
    layer2_tlb_transactions, render_timeline
from repro_torch.core.tracing import TraceBuffer, EventType, HOST_TRACER_ID


def test_device_record_inside_a_step():
    tb = TraceBuffer(capacity=16)

    def step(dev, x):
        dev = TraceBuffer.record(dev, 1, EventType.STEP_BEGIN, 0, 0)
        y = x * 2
        dev = TraceBuffer.tick(dev, 3)
        dev = TraceBuffer.record(dev, 1, EventType.STEP_END, 0, 0)
        return dev, y

    dev = tb.device_init("cpu")
    dev, y = step(dev, torch.ones(4))
    rows = tb.drain(dev)
    assert rows.shape == (2, 5) and rows.dtype == np.int64
    assert rows[0, 2] == EventType.STEP_BEGIN
    assert rows[1, 2] == EventType.STEP_END
    assert rows[1, 0] - rows[0, 0] == 4  # 1 record + 3 ticks


def test_capacity_saturation_counts_drops():
    tb = TraceBuffer(capacity=4)
    dev = tb.device_init("cpu")
    for _ in range(7):
        dev = TraceBuffer.record(dev, 2, EventType.MEM_READ, 0, 0)
    rows = tb.drain(dev)
    assert rows.shape[0] == 4
    assert tb.dropped == 3


def test_host_device_merge():
    tb = TraceBuffer(capacity=8)
    dev = tb.device_init("cpu")
    dev = TraceBuffer.record(dev, 1, EventType.MEM_WRITE, 5, 6)
    tb.record_host(EventType.OFFLOAD_BEGIN, 1, 2)
    rows = tb.drain(dev)
    tracers = set(rows[:, 1].tolist())
    assert tracers == {1, HOST_TRACER_ID}


def test_analysis_layers():
    tb = TraceBuffer()
    tb.record_host(EventType.TLB_MISS, 0, 7)
    tb.record_host(EventType.TLB_L1_HIT, 1, 3)
    tb.record_host(EventType.MISS_HANDLED, 0, 7)
    tb.record_host(EventType.CORE_WAKE, 0, 7)
    events = layer1_decode(tb.drain())
    per_core = layer2_per_core(events)
    assert set(per_core) == {0, 1}
    txs = layer2_tlb_transactions(events)
    kinds = {t["kind"] for t in txs}
    assert kinds == {"miss", "hit_l1"}
    miss = [t for t in txs if t["kind"] == "miss"][0]
    assert miss["latency"] > 0
    assert "core   0" in render_timeline(events)


def _schedule(seed, n_ops):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["record", "record", "tick", "host"])
        if kind == "tick":
            ops.append(("tick", int(rng.integers(1, 5))))
        else:
            et = int(rng.choice([int(e) for e in EventType]))
            ops.append((kind, int(rng.integers(0, 8)), et,
                        int(rng.integers(0, 1000)),
                        int(rng.integers(-5, 1 << 20))))
    return ops


@pytest.mark.parametrize("seed,capacity,n_ops", [(0, 64, 40), (1, 8, 60),
                                                 (2, 1, 10)])
def test_device_recorder_rows_match_reference(seed, capacity, n_ops):
    """Same calls, same rows: timestamps, tracer ids, types, args, the
    saturated last row, the drop count and the (source, time) order."""
    jb, tb = JT.TraceBuffer(capacity=capacity), TraceBuffer(capacity=capacity)
    jd, td = jb.device_init(), tb.device_init("cpu")
    jrec = jax.jit(JT.TraceBuffer.record, static_argnums=(1, 2))
    for op in _schedule(seed, n_ops):
        if op[0] == "tick":
            jd = JT.TraceBuffer.tick(jd, op[1])
            td = TraceBuffer.tick(td, op[1])
        elif op[0] == "host":
            jb.record_host(EventType(op[2]), op[3], op[4])
            tb.record_host(EventType(op[2]), op[3], op[4])
        else:
            # a1 as a device value, as a jitted step would pass it
            jd = jrec(jd, op[1], op[2], op[3], jnp.int32(op[4]))
            td = TraceBuffer.record(td, op[1], op[2], op[3],
                                    torch.tensor(op[4], dtype=torch.int32))
    for k in ("count", "clock"):
        assert int(td[k]) == int(jd[k])
    np.testing.assert_array_equal(td["events"].numpy(),
                                  np.asarray(jd["events"]))
    np.testing.assert_array_equal(tb.drain(td), jb.drain(jd))
    assert tb.dropped == jb.dropped


def test_record_and_tick_never_sync_with_the_host(monkeypatch):
    """The recorder reads nothing back: every way a tensor's value reaches
    Python is made to raise while ``record`` and ``tick`` run."""
    tb = TraceBuffer(capacity=4)
    dev = tb.device_init("cpu")

    def boom(*_a, **_k):
        raise AssertionError("host sync inside the recorder")

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "numpy", "cpu", "__int__",
                     "__index__", "__bool__", "__float__"):
            mp.setattr(torch.Tensor, name, boom)
        with pytest.raises(AssertionError, match="host sync"):
            int(dev["count"])                  # the patch is in force
        for i in range(6):
            dev = TraceBuffer.record(dev, 3, EventType.SYNC, i,
                                     torch.tensor(i, dtype=torch.int32))
            dev = TraceBuffer.tick(dev, 2)
    rows = tb.drain(dev)
    assert rows.shape == (4, 5) and tb.dropped == 2
    assert rows[-1].tolist() == [15, 3, int(EventType.SYNC), 5, 5]
