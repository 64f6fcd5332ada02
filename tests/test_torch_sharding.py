"""The port's logical-axis sharding against the reference's.

``logical_pspec`` of every leaf of ``param_axes``, ``cache_axes`` (both
decode shapes), ``input_axes`` (every shape) and ``train_state_axes``
(with the gradient-compression residual) must equal the reference's,
for every registered arch, every profile and the meshes (1,), (2, 4),
(16, 16) and (2, 16, 16).  The reference side runs in one subprocess
with 512 virtual XLA devices (its ``kv_cache_axes`` reads the active
mesh); the port needs no devices: a mapping of axis sizes stands in for
the mesh.  The reference stacks a layer stack's leaves as ``(L, ...)``,
the port keeps them per layer, so a stacked leaf's partition is compared
without its (always replicated) stack dim.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.models import model as M
from repro_torch.models import steps as ST
from repro_torch.parallel import sharding as SH

ROOT = Path(__file__).resolve().parents[1]
PROFILES = ("megatron", "fsdp", "serve")
MESHES = {"1": {"model": 1}, "2x4": {"data": 2, "model": 4},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}

PROBE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import SHAPES, get_config, list_archs
from repro.models import model as JM
from repro.models import steps as JST
from repro.parallel.sharding import (Axes, logical_pspec, mesh_context,
                                     sharding_profile)

MESHES = json.loads(sys.argv[1])


def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def walk(specs, axes, mesh):
    flat_s = jax.tree_util.tree_flatten_with_path(specs)[0]
    flat_a = jax.tree_util.tree_flatten(
        axes, is_leaf=lambda x: isinstance(x, Axes))[0]
    out = {}
    for (path, sds), ax in zip(flat_s, flat_a):
        spec = [None if e is None else (list(e) if isinstance(e, tuple)
                                        else e)
                for e in logical_pspec(sds.shape, ax.axes, mesh)]
        out[key(path)] = spec + [None] * (len(sds.shape) - len(spec))
    return out


out = {}
for arch in list_archs():
    cfg = get_config(arch)
    for prof in ("megatron", "fsdp", "serve"):
        for name, sizes in MESHES.items():
            mesh = jax.make_mesh(tuple(sizes.values()), tuple(sizes))
            with sharding_profile(prof), mesh_context(mesh):
                rec = {"params": walk(JM.param_specs(cfg),
                                      JM.param_axes(cfg), mesh)}
                for s in SHAPES.values():
                    rec["inputs/" + s.name] = walk(
                        JST.input_specs(cfg, s), JST.input_axes(cfg, s), mesh)
                    if s.kind == "decode":
                        B, T = s.global_batch, max(cfg.cache_len(s), 1)
                        rec["cache/" + s.name] = walk(
                            JM.cache_specs(cfg, B, T),
                            JM.cache_axes(cfg, B, T), mesh)
                ocfg = JST.default_opt_cfg(cfg)
                rec["state"] = walk(
                    JST.train_state_specs(cfg, ocfg, compress=True),
                    JST.train_state_axes(cfg, ocfg, compress=True), mesh)
            out[f"{arch}|{prof}|{name}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", PROBE, json.dumps(MESHES)],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _norm(spec):
    """Trailing replicated dims dropped, entries as lists."""
    out = [list(e) if isinstance(e, tuple) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return out


def _ref_key(path: str) -> tuple:
    """A port path's reference leaf and whether the reference stacks it:
    ``layers/3/attn/wq`` -> (``layers/attn/wq``, True)."""
    keys, layer = M._reference_path(path)
    return "/".join(keys), layer is not None


def _compare(ref: dict, port_specs: dict, kind: str):
    assert port_specs, kind
    for path, spec in port_specs.items():
        rkey, stacked = _ref_key(path)
        want = ref[rkey][1:] if stacked else ref[rkey]
        assert _norm(spec) == _norm(want), (kind, path, spec, want)


def _cache_specs(cfg, shape, sizes):
    """The port's cache partition, keyed as the reference's cache tree
    (a per-layer list's leaves as ``<stack>/<i>``, stacked there)."""
    B, T = shape.global_batch, max(cfg.cache_len(shape), 1)
    specs = SH.tree_pspecs(M.cache_specs(cfg, B, T), M.cache_axes(cfg, B, T),
                           sizes)
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                out[f"{prefix}{i}"] = v
        else:
            out[prefix[:-1]] = node
    walk(specs, "")
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", list_archs())
def test_logical_pspec_matches_reference(reference, arch, profile, mesh):
    cfg = get_config(arch)
    sizes = MESHES[mesh]
    ref = reference[f"{arch}|{profile}|{mesh}"]
    with SH.sharding_profile(profile), SH.mesh_context(sizes):
        shapes = M.param_shapes(cfg)
        axes = M.param_axes(cfg)
        _compare(ref["params"], {p: SH.logical_pspec(s, axes[p].axes, sizes)
                                 for p, s in shapes.items()}, "params")
        for s in SHAPES.values():
            specs = SH.tree_pspecs(ST.input_specs(cfg, s),
                                   ST.input_axes(cfg, s), sizes)
            assert set(specs) == set(ref["inputs/" + s.name])
            _compare(ref["inputs/" + s.name], specs, s.name)
            if s.kind == "decode":
                cref = ref["cache/" + s.name]
                port = _cache_specs(cfg, s, sizes)
                for path, spec in port.items():
                    head, _, tail = path.rpartition("/")
                    stacked = tail.isdigit()
                    rkey = head if stacked else path
                    want = cref[rkey][1:] if stacked else cref[rkey]
                    assert _norm(spec) == _norm(want), (s.name, path)
                assert {p.rpartition("/")[0] if p.rpartition("/")[2]
                        .isdigit() else p for p in port} == set(cref)
        ocfg = ST.default_opt_cfg(cfg)
        state = SH.tree_pspecs(ST.train_state_specs(cfg, ocfg, True),
                               ST.train_state_axes(cfg, ocfg, True), sizes)
        flat = {}
        for group, sub in state.items():
            if group == "opt":
                for k, v in sub.items():
                    if k == "step":
                        flat["opt/step"] = v
                    else:
                        flat.update({f"opt/{k}/{p}": s for p, s in v.items()})
            else:
                flat.update({f"{group}/{p}": s for p, s in sub.items()})
        for path, spec in flat.items():
            head, rest = path.split("/", 1) if not path.startswith("opt/") \
                else ("/".join(path.split("/")[:2]),
                      "/".join(path.split("/")[2:]))
            if path == "opt/step":
                assert _norm(spec) == _norm(ref["state"]["opt/step"])
                continue
            rkey, stacked = _ref_key(rest)
            want = ref["state"][f"{head}/{rkey}"]
            assert _norm(spec) == _norm(want[1:] if stacked else want), path
        assert len({p.split("/")[0] for p in ref["state"]}) == 3


def test_logical_pspec_divisibility():
    """The reference's four rules, on the port (``tests/test_system.py``)."""
    assert SH.logical_pspec((25, 64), ("tp", None), {"model": 1}) == ()
    mesh = {"data": 2, "model": 4}
    assert SH.logical_pspec((32, 64), ("dp", "tp"), mesh) == ("data",
                                                              "model")
    assert SH.logical_pspec((25, 64), ("tp", None), mesh) == ()
    assert SH.logical_pspec((8, 25), ("dp", "tp"), mesh) == ("data",)
    mesh3 = {"pod": 2, "data": 2, "model": 2}
    assert SH.logical_pspec((8, 8), ("fsdp", "tp"), mesh3) == (
        ("pod", "data"), "model")


def test_prefix_only_and_no_axis_twice():
    """Only a prefix of a logical axis's physical axes that divides the
    dim is kept, and a mesh axis serves one dim at most."""
    mesh3 = {"pod": 2, "data": 16, "model": 16}
    # 6 = 2 * 3: "pod" divides, "pod" * "data" does not
    assert SH.logical_pspec((6, 8), ("dp", None), mesh3) == ("pod",)
    # the second "tp" dim finds "model" taken
    assert SH.logical_pspec((16, 16), ("tp", "tp"), mesh3) == ("model",)
    with SH.sharding_profile("fsdp"):
        assert SH.logical_pspec((512, 4), ("fsdp", None), mesh3) == (
            ("pod", "data", "model"),)


def test_shard_is_the_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert SH.current_mesh() is None
    assert SH.shard(x, "dp", "sp", None) is x
    with SH.mesh_context(None):
        assert SH.shard(x, "dp", None, "tp") is x


def test_roofline_prices_collectives_by_host_span(monkeypatch):
    """A mesh within one 8-card NVLink host prices its collective bytes
    at NVLink's rate; a production mesh, whose every axis crosses hosts,
    at the inter-host rate (both the data sheets', not measured)."""
    from repro_torch.hero import roofline_table as RT
    from repro_torch.launch import mesh as MS
    assert MS.link_bw(4) == MS.link_bw(MS.NVLINK_DOMAIN) == MS.NVLINK_BW
    assert MS.link_bw(256) == MS.link_bw(512) == MS.INTERNODE_BW
    assert MS.INTERNODE_BW < MS.NVLINK_BW
    for devices in (4, 256):
        rec = {"status": "ok", "devices": devices, "dot_flops": 1e12,
               "collective_bytes": 3e9, "cost": {"flops": 1e12},
               "memory": {"argument_size_in_bytes": 0,
                          "temp_size_in_bytes": 0}}
        monkeypatch.setattr(RT, "load_cell", lambda *a, rec=rec: rec)
        row = RT.analyze_cell("yi-6b", "train_4k")
        assert row["t_collective"] == 3e9 / MS.link_bw(devices)
        assert row["link_bw"] == MS.link_bw(devices)
