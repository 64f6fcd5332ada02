"""The port's configs, model layout and layer primitives against JAX.

Every primitive is fed the same numpy inputs and weights as the
reference's function and must agree at float32 within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import (
    SHAPES, get_config, list_archs, param_count,
)
from repro_torch.models import layers as TL
from repro_torch.models.model import init_params, param_shapes, \
    params_from_jax

ATOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw):
    j = dataclasses.replace(j_get_config("yi-6b").smoke(),
                            param_dtype="float32", **kw)
    t = dataclasses.replace(get_config("yi-6b").smoke(),
                            param_dtype="float32", **kw)
    return j, t


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t, **tol):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **(tol or ATOL))


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b", "gemma2-2b",
                                  "minitron-8b", "olmoe-1b-7b",
                                  "xlstm-350m", "hymba-1.5b",
                                  "whisper-medium", "pixtral-12b",
                                  "deepseek-v2-236b"])
def test_configs_and_param_count_match_jax(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_get_config(arch).smoke(), get_config(arch).smoke())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert param_count(t) == j_base.param_count(j)
    assert list_archs() == ["xlstm-350m", "pixtral-12b", "gemma2-2b",
                            "yi-6b", "minitron-8b", "qwen3-32b",
                            "hymba-1.5b", "deepseek-v2-236b",
                            "olmoe-1b-7b", "whisper-medium"]
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}


@pytest.mark.parametrize("arch", ["yi-6b", "qwen3-32b", "gemma2-2b",
                                  "minitron-8b", "olmoe-1b-7b",
                                  "xlstm-350m", "hymba-1.5b",
                                  "whisper-medium", "pixtral-12b",
                                  "deepseek-v2-236b"])
def test_params_from_jax_unstacks_exactly(arch):
    jcfg = j_get_config(arch).smoke()
    tcfg = get_config(arch).smoke()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    for path in param_shapes(tcfg):
        parts = path.split("/")
        if parts[0] in ("first_layers", "layers", "mlstm_layers",
                        "slstm_layers", "enc_layers", "dec_layers"):
            ref = params[parts[0]][parts[2]]
            for key in parts[3:]:
                ref = ref[key]
            ref = ref[int(parts[1])]
        else:
            ref = params[parts[0]]
            for key in parts[1:]:
                ref = ref[key]
        got = model.param(path)
        assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_init_params_seeded_layout():
    cfg = get_config("yi-6b").smoke()
    a, b = init_params(cfg, seed=3, device="cpu"), \
        init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    wq = a.layers[0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and tuple(wq.shape) == (64, 4, 16)
    assert a.layers[1]["ln2"]["scale"].dtype == torch.float32
    assert bool((a.final_norm["scale"] == 1).all())
    assert torch.equal(wq, b.layers[0]["attn"]["wq"])
    assert not torch.equal(wq, c.layers[0]["attn"]["wq"])
    # normal / sqrt(fan_in): fan_in d for wq, H*hd for wo, ff for w_down
    for w, fan in ((wq, 64), (a.layers[0]["attn"]["wo"], 64),
                   (a.layers[0]["mlp"]["w_down"], 128)):
        assert abs(float(w.float().std()) * fan ** 0.5 - 1.0) < 0.1
    assert all(not p.requires_grad for p in a.parameters())


@pytest.mark.parametrize("layer_norm", [False, True])
def test_norm_forward(layer_norm):
    jcfg, tcfg = _cfg()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if layer_norm:
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jx, tx = _both(x)
    _eq(JL.norm_forward(jcfg, jp, jx), TL.norm_forward(tcfg, tp, tx))


def test_rms_head_norm_and_softcap():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    (jx, tx), (js, ts) = _both(x), _both(s)
    _eq(JL.rms_head_norm(js, jx, 1e-6), TL.rms_head_norm(ts, tx, 1e-6))
    _eq(JL.softcap(jx * 40, 30.0), TL.softcap(tx * 40, 30.0))
    assert TL.softcap(tx, 0.0) is tx


@pytest.mark.parametrize("theta", [10_000.0, 5_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    _eq(JL.rope(jx, jp, theta), TL.rope(tx, tp, theta))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_forward(kind):
    jcfg, tcfg = _cfg(mlp_kind=kind)
    rng = np.random.default_rng(3)
    p = {"w_up": rng.standard_normal((64, 128)), "w_down":
         rng.standard_normal((128, 64)), "w_gate":
         rng.standard_normal((64, 128))}
    p = {k: (v / 8).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jx, tx = _both(x)
    _eq(JL.mlp_forward(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jx),
        TL.mlp_forward(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       tx))


def test_layer_weights_carried_from_jax():
    """The primitives on the weights params_from_jax carried over."""
    jcfg, tcfg = _cfg()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                            device="cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jx, tx = _both(x)
    jl = jax.tree.map(lambda a: a[1], params["layers"])
    tl = model.layers[1]
    _eq(JL.norm_forward(jcfg, jl["ln2"], jx),
        TL.norm_forward(tcfg, tl["ln2"], tx))
    _eq(JL.mlp_forward(jcfg, jl["mlp"], jx),
        TL.mlp_forward(tcfg, tl["mlp"], tx))
    tok = rng.integers(0, 256, (2, 7)).astype(np.int32)
    jt, tt = _both(tok)
    _eq(JL.embed_tokens(jcfg, params["embed"], jt),
        TL.embed_tokens(tcfg, model.embed, tt))
    h = JL.embed_tokens(jcfg, params["embed"], jt)
    _eq(JL.logits_from_hidden(jcfg, params["embed"], h),
        TL.logits_from_hidden(tcfg, model.embed,
                              torch.from_numpy(np.array(h))))


@pytest.mark.parametrize("tied,cap,scaled", [(False, 0.0, False),
                                             (True, 30.0, True)])
def test_embed_and_bf16_logits(tied, cap, scaled):
    """bf16 head: logits come out float32 (the reference asks XLA for
    float32 output), including the vocabulary-sliced upcast path."""
    jcfg, tcfg = _cfg(tie_embeddings=tied, final_softcap=cap,
                      embedding_scale=scaled, vocab_size=20_000)
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((20_000, 64)) / 8).astype(np.float32)
    head = (rng.standard_normal((20_000, 64)) / 8).astype(np.float32)
    jp = {"table": jnp.asarray(table).astype(jnp.bfloat16)}
    tp = {"table": torch.from_numpy(table).bfloat16()}
    if not tied:
        jp["head"] = jnp.asarray(head).astype(jnp.bfloat16)
        tp["head"] = torch.from_numpy(head).bfloat16()
    tok = rng.integers(0, 20_000, (3, 4)).astype(np.int32)
    jt, tt = _both(tok)
    jx = JL.embed_tokens(jcfg, jp, jt)
    tx = TL.embed_tokens(tcfg, tp, tt)
    _eq(jx, tx)
    jl, tlg = JL.logits_from_hidden(jcfg, jp, jx), \
        TL.logits_from_hidden(tcfg, tp, tx)
    assert tlg.dtype == torch.float32 and tuple(tlg.shape) == (3, 4, 20_000)
    _eq(jl, tlg)
