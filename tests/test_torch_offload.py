"""The port's offload runtime (``OffloadTarget``, ``SVMSpace``) against
the reference's, on the CPU: the same host arrays from
``np.random.default_rng`` through copy mode and zero-copy mode give the
reference's outputs (float32 tolerance of ``tests/test_kernels.py``,
rtol = atol = 2e-4), its byte counts and its traced event rows exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload as JO
from repro.core import svm as JS
from repro.core import tracing as JT
from repro.kernels.cluster_matmul import cluster_matmul as j_matmul
from repro_torch.core import offload as TO
from repro_torch.core import svm as TS
from repro_torch.core import tracing as TT
from repro_torch.core.analysis import layer1_decode
from repro_torch.core.tracing import EventType
from repro_torch.kernels.cluster_matmul import cluster_matmul
from repro_torch.kernels.cluster_matmul import kernel as K

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal((n, n)).astype(np.float32))


def _run_both_modes(n=64):
    """The demo's sequence (copy mode, then zero-copy on shared inputs)
    on both packages, each with its own cluster matmul."""
    a, b = _inputs(n)
    jt = JO.OffloadTarget(tracer=JT.TraceBuffer())
    tt = TO.OffloadTarget(tracer=TT.TraceBuffer(), device="cpu")

    def jk(x, y):
        return j_matmul(x, y, interpret=True)

    def tk(x, y):
        return cluster_matmul(x, y)

    jc, jrc = jt.run_copy_based(jk, a, b)
    tc, trc = tt.run_copy_based(tk, a, b)
    jh = jt.run_zero_copy(jk, jt.svm.share(jax.device_put(a)),
                          jt.svm.share(jax.device_put(b)))
    th = tt.run_zero_copy(tk, tt.svm.share(torch.from_numpy(a)),
                          tt.svm.share(torch.from_numpy(b)))
    return dict(a=a, b=b, jt=jt, tt=tt, jc=jc, tc=tc, jrc=jrc, trc=trc,
                jh=jh, th=th)


def test_copy_and_zero_copy_match_reference_outputs():
    r = _run_both_modes()
    tz = r["tt"].svm.deref(r["th"][0])
    jz = np.asarray(r["jt"].svm.deref(r["jh"][0]))
    assert isinstance(r["tc"], np.ndarray) and isinstance(tz, torch.Tensor)
    np.testing.assert_allclose(r["tc"], r["jc"], **TOL)
    np.testing.assert_allclose(tz.numpy(), jz, **TOL)
    # one kernel, two offload modes: the port's outputs agree exactly
    np.testing.assert_array_equal(r["tc"], tz.numpy())
    np.testing.assert_allclose(r["tc"], r["a"] @ r["b"], **TOL)
    assert r["th"][0] == r["jh"][0]          # the same output handle


def test_reports_mode_and_bytes_match_reference():
    r = _run_both_modes()
    trc, jrc = r["trc"], r["jrc"]
    trz, jrz = r["th"][1], r["jh"][1]
    assert (trc.mode, trz.mode) == (jrc.mode, jrz.mode) == ("copy",
                                                           "zero_copy")
    assert (trc.bytes_to, trc.bytes_from) == (jrc.bytes_to, jrc.bytes_from) \
        == (2 * 64 * 64 * 4, 64 * 64 * 4)
    assert (trz.bytes_to, trz.bytes_from) == (jrz.bytes_to, jrz.bytes_from) \
        == (0, 0)
    assert trz.writeback_s == 0.0 and jrz.writeback_s == 0.0
    for rep in (trc, trz):
        assert rep.total_s == rep.offload_s + rep.kernel_s + rep.writeback_s


def test_drained_event_rows_match_reference():
    r = _run_both_modes()
    trows, jrows = r["tt"].tracer.drain(), r["jt"].tracer.drain()
    np.testing.assert_array_equal(trows, jrows)
    kinds = [e.etype for e in layer1_decode(trows)]
    assert kinds == [EventType.OFFLOAD_BEGIN, EventType.OFFLOAD_COPY_TO,
                     EventType.OFFLOAD_KERNEL_BEGIN,
                     EventType.OFFLOAD_KERNEL_END,
                     EventType.OFFLOAD_COPY_FROM, EventType.OFFLOAD_END,
                     EventType.OFFLOAD_BEGIN, EventType.OFFLOAD_KERNEL_BEGIN,
                     EventType.OFFLOAD_KERNEL_END, EventType.OFFLOAD_END]


def test_nested_host_args_bytes_and_events_match_reference():
    """Copy mode over nested containers (``None`` an empty subtree), with
    scalar and tuple outputs: the byte counts and events the reference's
    ``jax.tree`` flattening gives."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    d = {"b": rng.integers(0, 9, (5,)).astype(np.int32),
         "a": rng.standard_normal((3, 3)).astype(np.float32)}

    def fn(x, none, d):
        assert none is None
        return x.sum(), (d["a"] * 2, d["b"] + 1)

    jt = JO.OffloadTarget(tracer=JT.TraceBuffer())
    tt = TO.OffloadTarget(tracer=TT.TraceBuffer(), device="cpu")
    jout, jrep = jt.run_copy_based(fn, x, None, d)
    tout, trep = tt.run_copy_based(fn, x, None, d)
    assert (trep.bytes_to, trep.bytes_from) == (jrep.bytes_to,
                                                jrep.bytes_from)
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-6)
    np.testing.assert_array_equal(tout[1][0], jout[1][0])
    np.testing.assert_array_equal(tout[1][1], jout[1][1])
    np.testing.assert_array_equal(tt.tracer.drain(), jt.tracer.drain())


def test_bfloat16_host_arrays_stage_as_cpu_tensors():
    """numpy has no bfloat16: a CPU tensor is the port's bf16 host array
    (the reference stages an ml_dtypes bfloat16 array); bytes, events and
    values agree."""
    a, b = _inputs(64, seed=4)
    jt = JO.OffloadTarget(tracer=JT.TraceBuffer())
    tt = TO.OffloadTarget(tracer=TT.TraceBuffer(), device="cpu")
    jout, jrep = jt.run_copy_based(
        lambda x, y: j_matmul(x, y, interpret=True),
        np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
        np.asarray(jnp.asarray(b).astype(jnp.bfloat16)))
    tout, trep = tt.run_copy_based(cluster_matmul,
                                   torch.from_numpy(a).bfloat16(),
                                   torch.from_numpy(b).bfloat16())
    assert tout.dtype == torch.bfloat16 and tout.device.type == "cpu"
    assert (trep.bytes_to, trep.bytes_from) == (jrep.bytes_to,
                                                jrep.bytes_from) \
        == (2 * 64 * 64 * 2, 64 * 64 * 2)
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(tt.tracer.drain(), jt.tracer.drain())


def test_target_returns_fn_and_ignores_donate():
    tt = TO.OffloadTarget(device="cpu")

    def f(x):
        return x + 1

    assert tt.target(f, donate=(0,)) is f
    assert tt.target(f) is f
    if not torch.cuda.is_available():      # entry points default to cuda
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TO.OffloadTarget()


def test_svm_apertures_and_handle_numbering_match_reference():
    for reserved in (((0, 1 << 20),), ((0, 16), (100, 200)), ()):
        js, ts = JS.SVMSpace(reserved), TS.SVMSpace(reserved)
        assert ts.reserved == js.reserved and ts._next == js._next
        handles = [(js.share(jnp.zeros(1)), ts.share(torch.zeros(1)))
                   for _ in range(3)]
        assert all(j == t for j, t in handles)
        for h in (0, 15, 150, (1 << 20) - 1, handles[0][0]):
            errs = []
            for s, arr in ((js, jnp.zeros(1)), (ts, torch.zeros(1))):
                try:
                    s.share(arr, handle=h)
                    errs.append(None)
                except Exception as e:           # compare type + message
                    errs.append((type(e).__name__, str(e)))
            assert errs[0] == errs[1], (reserved, h, errs)
        j0, t0 = handles[0]
        ts.update(t0, torch.ones(2))
        assert ts.deref(t0).shape == (2,) and t0 in ts
        ts.release(t0)
        js.release(j0)
        assert (t0 in ts) == (j0 in js) is False


def test_demo_runs_on_the_cpu(capsys):
    from repro_torch.hero import svm_offload_demo
    K.launches.reset()
    rep_c, rep_z, (a, b), out_z = svm_offload_demo.main(device="cpu")
    out = capsys.readouterr().out
    assert "results identical across offload modes" in out
    assert "10 protocol events traced" in out
    assert rep_c.mode == "copy" and rep_z.mode == "zero_copy"
    assert rep_c.bytes_to == 2 * 256 * 256 * 4
    assert K.launches.n == 0                 # the CPU runs the plain version
    assert out_z.device.type == "cpu" and out_z.shape == (256, 256)
    np.testing.assert_allclose(out_z.numpy(), a @ b, rtol=1e-4, atol=1e-4)
