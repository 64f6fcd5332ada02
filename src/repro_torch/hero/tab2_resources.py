"""Tab.2 analogue from the port's dry-run records: per-device model state
against runtime overhead, the port of ``benchmarks/tab2_resources.py``.

    PYTHONPATH=src python -m repro_torch.hero.tab2_resources

The FPGA resource table (clusters against top level and host interface)
maps to one device's memory: model state (parameters, optimizer state,
decode cache: the "clusters") against the runtime overhead the step
adds on top (its activations, gradients and temporaries, the dry-run's
``memory.temp_size_in_bytes``: the "top level").  The paper's finding,
that the clusters dominate, is checked against the same split.  Model
state is the reference's analytic count (bf16 parameters, float32 m, v
and master for train; parameters and cache for decode) per device;
``args_gib`` beside it is the dry-run's own argument bytes.  It also
prints the PMCA configuration space (Tab.1) through the config graph.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.hero_pmca import JUNO_ADP, ZC706, pmca_config_space
from repro_torch.core.roofline import cache_bytes, param_counts
from repro_torch.hero.roofline_table import load_cell


def rows(mesh: str = "single"):
    out = []
    for arch in ("yi-6b", "qwen3-32b", "deepseek-v2-236b", "gemma2-2b"):
        cfg = get_config(arch)
        for shape_name in ("train_4k", "decode_32k"):
            rec = load_cell(arch, shape_name, mesh)
            if not rec or rec.get("status") != "ok":
                continue
            dev = rec["devices"]
            n = param_counts(cfg)["total"]
            shape = SHAPES[shape_name]
            if shape.kind == "train":
                state = n * (2 + 12) / dev  # bf16 params + fp32 m/v(+master)
            else:
                state = n * 2 / dev + cache_bytes(cfg, shape) / dev
            overhead = rec["memory"]["temp_size_in_bytes"]
            out.append({"arch": arch, "shape": shape_name,
                        "model_state_gib": state / 2 ** 30,
                        "runtime_overhead_gib": overhead / 2 ** 30,
                        "model_state_pct": 100 * state / max(state + overhead,
                                                             1),
                        "args_gib": rec["memory"]["argument_size_in_bytes"]
                        / 2 ** 30})
    return out


def main():
    print("# Tab.1 analogue: PMCA config space (graph-flattened)")
    g = pmca_config_space()
    print(f"config axes: {len(g.axes)}; flattened cells: {len(g)}")
    print(f"juno_adp preset: {JUNO_ADP}")
    print(f"zc706 preset: {ZC706}")

    print("\n# Tab.2 analogue: model state vs runtime overhead per device")
    print("arch,shape,model_state_gib,runtime_overhead_gib,model_state_pct,"
          "args_gib")
    for r in rows():
        print(f"{r['arch']},{r['shape']},{r['model_state_gib']:.2f},"
              f"{r['runtime_overhead_gib']:.2f},{r['model_state_pct']:.1f},"
              f"{r['args_gib']:.2f}")
    print("\nNOTE: runtime overhead is the eager step's peak of live local "
          "tensors on the fake mesh (PyTorch's caching allocator rounds and "
          "caches on a card); see PERF.md for one card's measured peak "
          "beside its prediction.")


if __name__ == "__main__":
    main()
