#!/usr/bin/env python3
"""How far the recurrent families' results stand from other valid
evaluations of the same weights (float64, another device, another
rounding): the evidence behind the bars that ``chip_smoke.py`` phase 17
and ``tests/test_torch_ssm.py`` / ``tests/test_torch_decode_bf16.py``
hold them to.

    PYTHONPATH=src python scripts/float64_check.py [--parts a,b,...]
        [--device cuda]

The port computes in float32 where the reference does.  To tell a
defect from rounding, this script also evaluates the same weights in
float64, through a copy of the port's model code whose float32 casts are
rewritten to float64 (written to ``build/float64/``, git-ignored), and
prints, as max |diff| / max |reference|:

* ``lockstep``: phase 17 (a) (each family at its lockstep depth, seed
  0, its prompt), float32 against float64 (always on the CPU): the
  prefill logits, then each step's logits of the prompt fed by
  ``decode_forward`` and ``LOCK_STEPS`` tokens after it (the CPU's
  greedy tokens, fed to every copy), each lane's worst step and the
  steps above 1e-5; for xlstm also the hidden state after each cell.
  With ``--device cuda`` the same float32 weights also run on the card,
  and the card's prefill and steps are compared with float64 and with
  the CPU's.
* ``decode``: ``decode_forward`` over a prompt against ``prefill_logits``
  of it, in float32 and in float64 (hymba 8 layers and S=64, xlstm 24
  layers and S=256; full width, seed 0).
* ``grads``: the smoke configs' loss gradients (``test_torch_ssm``'s
  weights and batch): the reference's eager and jitted float32, the
  port's float32 and float64; the worst leaf of each pair.
* ``reference``: the reference's own bf16 decode against its prefill, at
  full width and depth (hymba 32 layers, xlstm 24; S=64).
* ``bf16``: at the smoke configs, the reference's jitted bfloat16
  ``decode_forward`` against its op-by-op run (``jax.disable_jit``) and
  the port's against both, worst step of 24; and the reference's
  bfloat16 loss gradients with the embedding table nudged by one bf16
  ulp (x (1 +- 2^-8), three sign draws) against the unnudged ones, and
  the port's against the reference's, each leaf's worst, of its largest
  |g|.

``grads``, ``reference`` and ``bf16`` need the JAX package.  Memory: up
to ~8 GB (the reference's 32-layer hymba); ~10 min in all.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PARTS = ("lockstep", "decode", "grads", "reference", "bf16")
#: the port's files whose float32 casts the float64 copy rewrites
REWRITE = ("models/*.py", "kernels/flash_attention/ops.py",
           "kernels/flash_attention/ref.py")


def rel(a, b) -> float:
    a = torch.as_tensor(np.asarray(a, np.float64))
    b = torch.as_tensor(np.asarray(b, np.float64))
    return ((a - b).abs().max() / b.abs().max()).item()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().cpu().numpy()
    return np.asarray(t, np.float64)


#: spellings of float32 in code; none may be left after the rewrite
FLOAT32 = re.compile(r"\.float\(\)|torch\.float32\b|torch\.float\b(?!\w)"
                     r"|\bdtype=float\b")


def float64_port():
    """The port's modules re-imported from a copy whose float32 casts
    read float64 (``.float()`` -> ``.double()``, ``torch.float32`` ->
    ``torch.float64``); the float32 modules leave ``sys.modules``.  If
    the code spells float32 another way, the rewrite stops: a copy that
    still rounds to float32 somewhere would measure nothing."""
    dst = ROOT / "build" / "float64"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch")
    for pattern in REWRITE:
        for f in (dst / "repro_torch").glob(pattern):
            text = f.read_text()
            text = re.sub(r"\.float\(\)", ".double()", text)
            text = text.replace("torch.float32", "torch.float64")
            code = "\n".join(line.split("#")[0] for line in
                             text.splitlines())
            left = FLOAT32.findall(code)
            assert not left, f"{f.name}: float32 left after the rewrite: {left}"
            f.write_text(text)
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(dst))
    import repro_torch
    assert Path(repro_torch.__file__).parent == dst / "repro_torch"
    from repro_torch.models import model as M64
    return M64


def as_float64(M64, cfg, model):
    cfg64 = dataclasses.replace(cfg, param_dtype="float64")
    out = M64.DenseDecoder(cfg64, torch.device("cpu"))
    with torch.no_grad():
        for k, v in out.state_dict().items():
            v.copy_(model.state_dict()[k].double())
    return cfg64, out


def forced_decode(M, cfg, model, prompt, toks, steps):
    """The logits (B, V) after the prompt and after each of the first
    ``steps - 1`` tokens of ``toks`` (steps lists of B), fed one a step
    by ``decode_forward``: the rows ``greedy_decode`` chooses by."""
    B, P = prompt.shape
    dev = prompt.device
    cache = M.init_cache(cfg, B, P + steps - 1, dev)
    feed = [prompt[:, t] for t in range(P)] + [
        torch.tensor(t, dtype=torch.int32, device=dev)
        for t in toks[:steps - 1]]
    rows = []
    with torch.no_grad():
        for t, tok in enumerate(feed):
            lg, cache = M.decode_forward(
                cfg, model, cache, tok[:, None],
                torch.full((B,), t, dtype=torch.int32, device=dev))
            if t >= P - 1:
                rows.append(lg[:, 0].double().cpu())
    return rows


def lockstep_f32(device="cpu"):
    """Phase 17 (a)'s float32 prefill and decode rows on the CPU and, if
    ``device`` is not the CPU, on it too (the same weights)."""
    import copy

    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import ssm as S
    devices = ["cpu"] + ([device] if device != "cpu" else [])
    torch.backends.cuda.matmul.allow_tf32 = False      # as chip_smoke.py
    runs = {}
    for arch in CS.RECURRENT:
        cfg = dataclasses.replace(get_config(arch),
                                  num_layers=CS.LOCK_DEPTH[arch],
                                  param_dtype="float32")
        model = M.init_params(cfg, seed=0, device="cpu")
        prompt = CS.recurrent_prompt(cfg, CS.LOCK_B, CS.LOCK_PROMPT, 17,
                                     "cpu")
        toks, _, _ = CS.greedy_decode(cfg, model, prompt, CS.LOCK_STEPS)
        out = {}
        for dev in devices:
            m = model if dev == "cpu" else copy.deepcopy(model).to(dev)
            with torch.no_grad():
                pre = M.prefill_logits(cfg, m, {"tokens": prompt.to(dev)})
            out[dev] = (pre.double().cpu(), forced_decode(
                M, cfg, m, prompt.to(dev), toks, CS.LOCK_STEPS))
            del m
        with torch.no_grad():
            hidden = xlstm_cells(cfg, model, prompt, L, S) \
                if cfg.block_kind == "mlstm" else []
        runs[arch] = (cfg, model, prompt, toks, out, hidden)
    return runs


def step_rel(rows, ref):
    """Per lane, each step's max |diff| / max |logit| of ``ref``."""
    return [[rel(_np(a[lane]), _np(b[lane])) for a, b in zip(rows, ref)]
            for lane in range(ref[0].shape[0])]


def summary(per_lane) -> str:
    """Each lane's worst step and the steps above 1e-5."""
    return "; ".join(
        f"lane {i} worst {max(r):.3g} (step {r.index(max(r))}), above "
        f"1e-5: " + (", ".join(f"step {j} {x:.3g}" for j, x in enumerate(r)
                               if x > 1e-5) or "none")
        for i, r in enumerate(per_lane))


def xlstm_cells(cfg, model, prompt, L, S):
    """The residual stream after each cell, in the forward's order."""
    x = L.embed_tokens(cfg, model.embed, prompt)
    out = []
    cells = [model.slstm_layers[0]] + list(model.mlstm_layers)
    for j, lp in enumerate(cells):
        fn = S.slstm_fullseq if j == 0 else S.mlstm_fullseq
        x = x + fn(cfg, lp["cell"], L.norm_forward(cfg, lp["ln1"], x))
        out.append(x.clone())
    return out


def decode_pairs(M, cfg, model, S_):
    """(prefill logits, decode logits after the same S_ tokens)."""
    import chip_smoke as CS
    prompt = CS.recurrent_prompt(cfg, 2, S_, 19, "cpu")
    with torch.no_grad():
        pre = M.prefill_logits(cfg, model, {"tokens": prompt})[:, 0]
        cache = M.init_cache(cfg, 2, S_, "cpu")
        for t in range(S_):
            lg, cache = M.decode_forward(
                cfg, model, cache, prompt[:, t:t + 1],
                torch.full((2,), t, dtype=torch.int32))
    return pre, lg[:, 0]


DECODE = {"hymba-1.5b": (8, 64), "xlstm-350m": (24, 256)}


def decode_f32():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    runs = {}
    for arch, (layers, S_) in DECODE.items():
        cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                                  param_dtype="float32")
        model = M.init_params(cfg, seed=0, device="cpu")
        runs[arch] = (cfg, model, S_, decode_pairs(M, cfg, model, S_))
    return runs


def grads_f32():
    """The reference's eager and jitted float32 gradients and the port's,
    at ``test_torch_ssm``'s weights and batch."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    runs = {}
    for arch in ("hymba-1.5b", "xlstm-350m"):
        jcfg = dataclasses.replace(j_get_config(arch).smoke(),
                                   param_dtype="float32")
        cfg = dataclasses.replace(get_config(arch).smoke(),
                                  param_dtype="float32")
        npp = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(0)))
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss(p):
            return JM.loss_fn(jcfg, p, jb)
        jp = jax.tree.map(jnp.asarray, npp)
        eager = jax.grad(loss)(jp)
        jitted = jax.jit(jax.grad(loss))(jp)
        model = M.params_from_jax(cfg, npp, device="cpu")
        model.requires_grad_(True)
        M.loss_fn(cfg, model, {k: torch.from_numpy(v)
                               for k, v in batch.items()}).backward()
        ours = {p: model.param(p).grad for p in M.param_shapes(cfg)}
        runs[arch] = (cfg, model, batch, {
            p: (_np(M.reference_leaf(eager, p)),
                _np(M.reference_leaf(jitted, p)), _np(g))
            for p, g in ours.items()})
    return runs


def reference_bf16():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    for arch, layers in (("hymba-1.5b", 32), ("xlstm-350m", 24)):
        cfg = dataclasses.replace(j_get_config(arch), num_layers=layers)
        params = JM.init_params(cfg, jax.random.PRNGKey(0))
        toks = jnp.asarray(np.random.default_rng(19).integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        pre = jax.jit(lambda p, t: JM.prefill_logits(
            cfg, p, {"tokens": t}))(params, toks)[:, 0]
        cache = JM.init_cache(cfg, 2, 64)
        step = jax.jit(lambda p, c, t, pos: JM.decode_forward(
            cfg, p, c, t, pos))
        for t in range(64):
            lg, cache = step(params, cache, toks[:, t:t + 1],
                             jnp.full((2,), t, jnp.int32))
        print(f"reference {arch} bf16, {layers} layers, S=64: decode vs "
              f"prefill {rel(lg[:, 0], pre):.3g}", flush=True)
        del params, cache


def bf16_spread():
    """The ``bf16`` part: how far two valid bfloat16 evaluations of the
    smoke configs stand apart, beside the port's distance."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from repro.configs import get_config as j_get_config
    from repro.models import model as JM
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    def cfgs(arch):
        return (dataclasses.replace(j_get_config(arch).smoke(),
                                    param_dtype="bfloat16"),
                dataclasses.replace(get_config(arch).smoke(),
                                    param_dtype="bfloat16"))
    for arch in ("xlstm-350m", "hymba-1.5b"):
        jcfg, cfg = cfgs(arch)
        npp = jax.tree.map(np.asarray, JM.init_params(
            jcfg, jax.random.PRNGKey(0)))
        jp = jax.tree.map(jnp.asarray, npp)
        model = M.params_from_jax(cfg, npp, device="cpu")
        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 24)).astype(np.int32)

        def step(p, c, t, pos):
            return JM.decode_forward(jcfg, p, c, t, pos)
        jitted = jax.jit(step)
        jc, ec = JM.init_cache(jcfg, 2, 24), JM.init_cache(jcfg, 2, 24)
        tc = M.init_cache(cfg, 2, 24, "cpu")
        worst = [0.0, 0.0, 0.0]
        for t in range(24):
            tok, pos = jnp.asarray(toks[:, t:t + 1]), jnp.full((2,), t,
                                                               jnp.int32)
            jl, jc = jitted(jp, jc, tok, pos)
            with jax.disable_jit():
                el, ec = step(jp, ec, tok, pos)
            tl, tc = M.decode_forward(
                cfg, model, tc, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((2,), t, dtype=torch.int32))
            for i, (a, b) in enumerate(((jl, el), (tl, el), (tl, jl))):
                worst[i] = max(worst[i], rel(_np(a), _np(b)))
        print(f"bf16 {arch} smoke decode, worst of 24 steps (of max "
              f"|logit|): reference jitted vs op by op {worst[0]:.3g}, "
              f"port vs reference op by op {worst[1]:.3g}, port vs "
              f"reference jitted {worst[2]:.3g}", flush=True)

        toks = np.random.default_rng(0).integers(
            0, jcfg.vocab_size, (2, 33)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def grads(q):
            return jax.grad(lambda p: JM.loss_fn(jcfg, p, jb))(
                jax.tree.map(jnp.asarray, q))
        base = grads(npp)
        g32 = jax.grad(lambda p: JM.loss_fn(
            dataclasses.replace(jcfg, param_dtype="float32"), p, jb))(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), npp))
        model.requires_grad_(True)
        M.loss_fn(cfg, model, {k: torch.from_numpy(v)
                               for k, v in batch.items()}).backward()
        nudge = {p: 0.0 for p in M.param_shapes(cfg)}
        for seed in range(3):
            sign = np.random.default_rng(100 + seed).choice(
                [-1.0, 1.0], npp["embed"]["table"].shape)
            table = np.asarray(npp["embed"]["table"], np.float32)
            q = dict(npp, embed=dict(npp["embed"], table=(
                table * (1 + sign * 2.0 ** -8)).astype(ml_dtypes.bfloat16)))
            g = grads(q)
            for p in nudge:
                nudge[p] = max(nudge[p], rel(
                    _np(M.reference_leaf(g, p)),
                    _np(M.reference_leaf(base, p))))
        for p in nudge:
            ref = _np(M.reference_leaf(base, p))
            own = rel(ref, _np(M.reference_leaf(g32, p)))
            print(f"bf16 {arch} smoke grads {p}: reference bf16 vs float32 "
                  f"{own:.3g}, nudged by one ulp {nudge[p]:.3g}; port vs "
                  f"reference bf16 {rel(_np(model.param(p).grad), ref):.3g}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default=",".join(PARTS))
    ap.add_argument("--device", default="cpu",
                    help="a second device for the lockstep part")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    torch.manual_seed(0)
    if "reference" in parts:
        reference_bf16()
    if "bf16" in parts:
        bf16_spread()
    lock = lockstep_f32(args.device) if "lockstep" in parts else {}
    dec = decode_f32() if "decode" in parts else {}
    grads = grads_f32() if "grads" in parts else {}
    if not (lock or dec or grads):
        return 0
    M64 = float64_port()
    for arch, (cfg, model, prompt, toks, out, hidden) in lock.items():
        cfg64, m64 = as_float64(M64, cfg, model)
        with torch.no_grad():
            want = M64.prefill_logits(cfg64, m64, {"tokens": prompt})
        rows64 = forced_decode(M64, cfg64, m64, prompt, toks,
                               len(out["cpu"][1]))
        for dev, (pre, rows) in out.items():
            print(f"lockstep {arch} {cfg.num_layers} layers, {dev} float32 "
                  f"vs float64: prefill logits {rel(_np(pre), _np(want)):.3g}"
                  f"; decode steps {summary(step_rel(rows, rows64))}",
                  flush=True)
        for dev, (pre, rows) in out.items():
            if dev != "cpu":
                cpu_pre, cpu_rows = out["cpu"]
                print(f"lockstep {arch}: {dev} vs cpu float32: prefill "
                      f"logits {rel(_np(pre), _np(cpu_pre)):.3g}; decode "
                      f"steps {summary(step_rel(rows, cpu_rows))}",
                      flush=True)
        if hidden:
            from repro_torch.models import layers as L64
            from repro_torch.models import ssm as S64
            with torch.no_grad():
                ref = xlstm_cells(cfg64, m64, prompt, L64, S64)
            print(f"lockstep {arch}: hidden state vs float64 after each "
                  "cell (sLSTM, then mLSTM 0-6): " + ", ".join(
                      f"{rel(_np(a), _np(b)):.3g}"
                      for a, b in zip(hidden, ref)), flush=True)
    for arch, (cfg, model, S_, (pre, dec32)) in dec.items():
        cfg64, m64 = as_float64(M64, cfg, model)
        pre64, dec64 = decode_pairs(M64, cfg64, m64, S_)
        print(f"decode {arch} {cfg.num_layers} layers S={S_}: decode vs "
              f"prefill float32 {rel(_np(dec32), _np(pre)):.3g}, float64 "
              f"{rel(_np(dec64), _np(pre64)):.3g}; float32 against "
              f"float64: prefill {rel(_np(pre), _np(pre64)):.3g}, decode "
              f"{rel(_np(dec32), _np(dec64)):.3g}", flush=True)
    for arch, (cfg, model, batch, g) in grads.items():
        cfg64, m64 = as_float64(M64, cfg, model)
        m64.requires_grad_(True)
        M64.loss_fn(cfg64, m64, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}).backward()
        truth = {p: _np(m64.param(p).grad) for p in g}

        def worst(i, against=None):
            return max((rel(v[i], truth[p] if against is None
                            else v[against]), p) for p, v in g.items())
        print(f"grads {arch} smoke, worst leaf (of its largest |g|): "
              f"reference eager vs float64 {worst(0)[0]:.3g} "
              f"({worst(0)[1]}), port vs float64 {worst(2)[0]:.3g} "
              f"({worst(2)[1]}), port vs reference eager "
              f"{worst(2, 0)[0]:.3g}, reference jitted vs eager "
              f"{worst(1, 0)[0]:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
