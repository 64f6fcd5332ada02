"""Roofline table from the port's dry-run records, the port of
``benchmarks/roofline.py``.

    PYTHONPATH=src python -m repro_torch.hero.roofline_table [--mesh single]

Per (arch x shape x mesh) cell of ``artifacts/dryrun_torch/`` (written by
``python -m repro_torch.launch.dryrun``), three per-device terms in
roofline-model seconds (a model, not a measured time):

  compute    = FLOPs per device / PEAK_FLOPS_BF16         (measured, H100)
  memory     = bytes per device / HBM_BW                  (measured, H100)
  collective = collective bytes per device / link_bw(devices) (data sheet)

The peaks are ``launch.mesh``'s: the bf16 rate and HBM byte rate measured
on one NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 15), and
the link rate from data sheets, not measured: NVLink's within one 8-card
host, one 400 Gb/s InfiniBand port per card across hosts, which every
axis of the production meshes crosses (``launch.mesh.link_bw``).
The FLOPs are the dry-run's ``dot_flops`` (its ``cost.flops`` where
absent); the memory term is the analytic per-device model of
``core.roofline`` (weights and optimizer traffic plus activations or the
decode cache), as in the reference.  MODEL_FLOPS are ``6 N D`` (train),
``2 N D`` (prefill) and ``2 N`` a token (decode), N active for MoE;
``roofline_fraction`` is the useful model FLOPs' time over the dominant
term, ``attainment`` the unavoidable time over the bound.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.roofline import (
    analytic_bytes, model_flops, param_counts,
)
from repro_torch.launch.dryrun import ARTIFACTS, cell_path
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, link_bw

#: the production meshes' ``model`` axis: the serve profile keeps
#: weights split over it alone
MODEL_AXIS = 16


def load_cell(arch: str, shape: str, mesh: str,
              profile: str = "megatron") -> Optional[dict]:
    f = cell_path(arch, shape, mesh, profile)
    if not f.exists():
        return None
    return json.loads(f.read_text())


def analyze_cell(arch: str, shape_name: str, mesh: str = "single",
                 profile: str = "megatron",
                 kv_dtype: str = "bf16") -> Optional[dict]:
    rec = load_cell(arch, shape_name, mesh, profile)
    if rec is None or rec.get("status") != "ok":
        return rec
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    dev = rec["devices"]
    # the serve profile keeps weights split over `model` only: each
    # device reads params / tp, not params / devices
    weight_div = MODEL_AXIS if profile == "serve" else dev
    flops_dev = rec.get("dot_flops") or rec["cost"].get("flops", 0.0)
    mf_dev = model_flops(cfg, shape) / dev
    bytes_dev = analytic_bytes(cfg, shape, dev, kv_dtype) + \
        param_counts(cfg)["total"] * 2.0 * (1.0 / weight_div - 1.0 / dev)
    coll_dev = rec.get("collective_bytes", 0.0)

    terms = {"compute": flops_dev / PEAK_FLOPS_BF16,
             "memory": bytes_dev / HBM_BW,
             "collective": coll_dev / link_bw(dev)}
    dominant = max(terms, key=terms.get)
    t_model = mf_dev / PEAK_FLOPS_BF16
    bound = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "status": "ok",
        "profile": profile, "kv_dtype": kv_dtype, "devices": dev,
        "hlo_flops_dev": flops_dev,
        "model_flops_dev": mf_dev,
        "useful_ratio": mf_dev / max(flops_dev, 1e-30),
        "bytes_dev": bytes_dev,
        "arith_intensity": flops_dev / max(bytes_dev, 1e-30),
        "coll_bytes_dev": coll_dev, "link_bw": link_bw(dev),
        "t_compute": terms["compute"], "t_memory": terms["memory"],
        "t_collective": terms["collective"],
        "dominant": dominant,
        "roofline_fraction": t_model / max(terms[dominant], 1e-30),
        "attainment": max(t_model, terms["memory"]) / max(bound, 1e-30),
        "trace_s": rec.get("trace_s"),
        "temp_gib": rec["memory"]["temp_size_in_bytes"] / 2 ** 30,
        "args_gib": rec["memory"]["argument_size_in_bytes"] / 2 ** 30,
    }


def full_table(mesh: str = "single", kv_dtype: str = "bf16",
               profile: str = "megatron") -> List[dict]:
    rows = []
    archs = sorted({f.name.split("__")[0] for f in ARTIFACTS.glob("*.json")})
    for arch in archs:
        for shape in SHAPES:
            rec = load_cell(arch, shape, mesh, profile)
            if rec is None:
                continue
            if rec.get("status") != "ok":
                rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": rec.get("status"),
                             "reason": rec.get("reason")
                             or rec.get("error", "")})
            else:
                rows.append(analyze_cell(arch, shape, mesh, profile,
                                         kv_dtype))
    return rows


def render_markdown(rows: List[dict]) -> str:
    hdr = ("| arch | shape | compute s* | memory s* | collective s* "
           "| dominant "
           "| MODEL/HLO | roofline frac | attainment "
           "| what would move the dominant term |")
    lines = [hdr, "|" + "---|" * 10]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | — | — | — | "
                         f"{str(r['reason'])[:60]} |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3e} | "
            f"{r['t_memory']:.3e} | {r['t_collective']:.3e} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['attainment']:.3f} | "
            f"{_improvement_hint(r)} |")
    lines.append("\n*roofline-model seconds per device, not measured: "
                 "the H100's measured bf16 and HBM peaks, the links' "
                 "data-sheet rates (`launch.mesh.link_bw`)")
    return "\n".join(lines)


def _improvement_hint(r: dict) -> str:
    if r["dominant"] == "collective":
        return ("reduce per-layer resharding: fewer TP gathers (wider FSDP), "
                "or EP-local MoE dispatch")
    if r["dominant"] == "memory":
        if r["shape"].startswith("decode") or r["shape"].startswith("long"):
            if r.get("kv_dtype") == "int8":
                return ("KV already int8: batch more requests / MLA-style "
                        "compression")
            return "quantize KV cache (kv_dtype=int8) / MLA-style compression"
        return "fuse activations (flash kernel), larger remat leaves"
    if r["useful_ratio"] < 0.8:
        return "cut remat recompute (dots-saveable policy) / drop redundant fp32"
    return "near roofline: overlap remaining collectives"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--profile", default="megatron",
                    choices=["megatron", "fsdp", "serve"])
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="KV-pool storage dtype for the decode-cache "
                         "byte model (int8 = quantized serving path)")
    args = ap.parse_args(argv)
    rows = full_table(args.mesh, args.kv_dtype, args.profile)
    if args.csv:
        print("arch,shape,kv_dtype,t_compute,t_memory,t_collective,dominant,"
              "useful_ratio,arith_intensity,roofline_fraction")
        for r in rows:
            if r.get("status") == "ok":
                print(f"{r['arch']},{r['shape']},{r['kv_dtype']},"
                      f"{r['t_compute']:.4e},{r['t_memory']:.4e},"
                      f"{r['t_collective']:.4e},{r['dominant']},"
                      f"{r['useful_ratio']:.3f},{r['arith_intensity']:.3f},"
                      f"{r['roofline_fraction']:.4f}")
    else:
        print(render_markdown(rows))


if __name__ == "__main__":
    main()
