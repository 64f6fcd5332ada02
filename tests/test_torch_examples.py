"""The reference's two examples as the port's entry points, on the CPU:
``launch/train_100m.py`` against ``examples/train_100m.py`` and
``launch/serve_paged.py`` against ``examples/serve_paged.py`` (both
loaded by path).

* ``model_100m()`` and the ``--smoke`` run (config, steps, batch,
  sequence, checkpoint and log intervals, the parameter estimate's line)
  equal the reference's, read from its ``main`` with its ``Trainer``
  replaced by a recorder;
* the port's ``--smoke`` run trains on the CPU, commits checkpoints, and
  its loss decreases;
* ``serve_paged.run`` on the reference's float32 smoke weights
  (``params_from_jax``) prints what the reference's example prints on
  the JAX engine with the same weights and schedule: every streamed
  delta, the served line (iterations, h2d/d2h, preemptions), each
  request's tokens, finish reason, prefix-hit tokens and preemptions,
  the RAB, pool and backing-store stats, the trace's TLB transactions
  and request lifecycles.  float32: bf16 weights would let the two
  frameworks' roundings flip tokens at near-ties.
"""
import contextlib
import dataclasses
import io
import sys

import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config
from repro_torch.launch import serve_paged as TS
from repro_torch.launch import train_100m as TT
from repro_torch.models.model import params_from_jax
from test_torch_hero import _reference


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_config(port, ref):
    """Every field of the reference's config, equal on the port's."""
    theirs, ours = _fields(ref), _fields(port)
    assert set(theirs) <= set(ours)
    assert {k: ours[k] for k in theirs} == theirs


class _Recorder:
    """Stands in for a ``Trainer``: records what it was built with and
    returns two logged steps of decreasing loss."""
    seen = []

    def __init__(self, cfg, shape, data, tcfg, **kw):
        _Recorder.seen.append((cfg, shape, tcfg))

    def run_with_recovery(self):
        return {"metrics": [{"step": 0, "loss": 2.0, "step_s": 0.1},
                            {"step": 1, "loss": 1.0, "step_s": 0.1}],
                "final_step": 2, "stragglers": [], "restarts": 0}


def _recorded(main, module, argv, monkeypatch):
    """(config, shape, trainer config, first printed line) of ``main``
    run with ``module.Trainer`` replaced by :class:`_Recorder`."""
    monkeypatch.setattr(module, "Trainer", _Recorder)
    _Recorder.seen.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main()
    (cfg, shape, tcfg), = _Recorder.seen
    return cfg, shape, tcfg, buf.getvalue().splitlines()[0]


@pytest.mark.parametrize("smoke", [False, True])
def test_train_100m_config_matches_reference(smoke, monkeypatch, tmp_path):
    ref = _reference("examples/train_100m.py")
    _same_config(TT.model_100m(), ref.model_100m())
    argv = ["--ckpt", str(tmp_path)] + (["--smoke"] if smoke else [])
    monkeypatch.setattr(sys, "argv", ["train_100m.py"] + argv)
    theirs = _recorded(ref.main, ref, argv, monkeypatch)
    ours = _recorded(lambda: TT.main(argv + ["--device", "cpu"]), TT, argv,
                     monkeypatch)
    _same_config(ours[0], theirs[0])
    assert (ours[1].seq_len, ours[1].global_batch, ours[1].kind) \
        == (theirs[1].seq_len, theirs[1].global_batch, theirs[1].kind)
    for k in ("total_steps", "ckpt_every", "ckpt_dir", "log_every"):
        assert getattr(ours[2], k) == getattr(theirs[2], k), k
    assert ours[3] == theirs[3]          # "model ~NM params, ..."
    assert TT.param_estimate(ours[0]) > (5e5 if smoke else 1e8)


def test_train_100m_smoke_trains_and_commits(tmp_path, capsys):
    res = TT.main(["--smoke", "--device", "cpu", "--ckpt", str(tmp_path)])
    steps, batch, seq = TT.SMOKE_RUN
    assert res["final_step"] == steps and res["restarts"] == 0
    assert latest_step(str(tmp_path)) == steps
    committed = sorted(p.name for p in tmp_path.iterdir()
                       if (p / "COMMITTED").exists())
    assert committed == [f"step_{s:08d}" for s in (10, 20, 30)]
    losses = [m["loss"] for m in res["metrics"]]
    assert losses[-1] < losses[0]
    assert "checkpoints committed under" in capsys.readouterr().out


def _report(lines) -> list:
    """The printed report up to the timeline (whose rows are cut to 2,000
    characters)."""
    return lines[:lines.index("# timeline (truncated)")]


def test_serve_paged_matches_reference_engine(monkeypatch):
    jcfg = dataclasses.replace(j_get_config("yi-6b"), param_dtype="float32")
    tcfg = dataclasses.replace(get_config("yi-6b").smoke(),
                               param_dtype="float32")
    ref = _reference("examples/serve_paged.py")
    monkeypatch.setattr(ref, "get_config", lambda arch: jcfg)
    monkeypatch.setattr(sys, "argv", ["serve_paged.py"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    theirs = buf.getvalue().splitlines()

    npp = jax.tree.map(np.asarray, JM.init_params(jcfg.smoke(),
                                                  jax.random.PRNGKey(0)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = TS.run(tcfg, params_from_jax(tcfg, npp, "cpu"), device="cpu")
    ours = buf.getvalue().splitlines()
    assert _report(ours) == _report(theirs)
    assert got["preemptions"] == 1 and got["results"][1]["preemptions"] == 1
    assert got["lifecycles"][1] == ["admit", "preempt", "swap_in", "admit",
                                    "finish"]
    assert sum(r["prefix_hit_tokens"] for r in got["results"].values()) \
        == got["pool"]["prefix_hit_tokens"] > 0
    assert set(got["results"]) == set(range(8)) | {99}
