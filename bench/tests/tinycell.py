"""A cell small enough for the CPU tests: the harness's own code on a tiny
model, run by ``harness.cell.run_cell`` with ``device="cpu"``."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import cell as C  # noqa: E402

DENSE = {"name": "tiny", "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_hidden_layers": 2,
         "num_key_value_heads": 2, "vocab_size": 256, "rms_norm_eps": 1e-5,
         "rope_theta": 10000.0, "tie_word_embeddings": False}
MOE = dict(DENSE, name="tiny-moe", intermediate_size=32, num_experts=8,
           num_experts_per_tok=2, qk_norm="per_head")
OPEN = {"loop": "open", "block": 8,
        "prompt": {"dist": "lognormal", "median": 24, "sigma": 0.6,
                   "min": 8, "max": 48},
        "output": {"dist": "uniform", "min": 3, "max": 8}}
ENGINE = {"max_lanes": 4, "chunk": 8, "page_size": 4, "kv_dtype": "bf16",
          "prefix_cache": True, "memory_utilization": 0.9}


def cell(conf=DENSE, mix=OPEN, limit=0.25, check=None, trace=1.0):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = {"engine": ENGINE, "rate_per_s": 20.0, "lead_in_s": 0.5,
            "trace_seconds": trace,
            "check": check or {"min_tokens": 10_000, "max_requests": 10_000},
            "limits": {"max_gap": limit}}
    return C.Cell(name="tiny", entry={"chips": 1}, spec=spec, conf=conf,
                  mix=mix, metrics={"end_to_end": bench["end_to_end"],
                                    "per_layer": bench["per_layer"]})


def run(c, seed=7, seconds=4.0, trace=False, **kw):
    """One run on the CPU in one thread: the test workers share the
    machine, and a window must still finish requests when they do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return C.run_cell("tiny", seed, seconds, trace, time.monotonic(),
                          device="cpu", cell=c, total_memory=4_000_000,
                          **kw)
    finally:
        torch.set_num_threads(threads)
