"""Quickstart, the port of ``examples/quickstart.py``: train a tiny model,
checkpoint it, decode from it.

    python -m repro_torch.launch.quickstart [--arch yi-6b] [--steps 20] \
        [--device cpu]

Trains the arch's smoke config with ``Trainer`` (checkpoints in a new
temporary directory), then greedy-decodes 8 tokens from the trained
weights through ``init_cache`` / ``decode_forward``.  Runs on ``cuda``
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.configs import get_config, smoke_shape
from repro_torch.data import MarkovChainData
from repro_torch.models import model as M
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).smoke()
    shape = smoke_shape("train")
    data = MarkovChainData(cfg, shape, seed=0)
    ckpt = tempfile.mkdtemp(prefix="quickstart_ckpt_")
    trainer = Trainer(cfg, shape, data,
                      TrainerConfig(total_steps=args.steps, ckpt_every=10,
                                    ckpt_dir=ckpt, log_every=5),
                      device=args.device)
    res = trainer.run()
    for m in res["metrics"]:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['step_s']*1e3:.0f} ms")

    # greedy-decode a few tokens from the trained model
    params, dev = res["state"]["params"], trainer.device
    cache = M.init_cache(cfg, 1, 16, dev)
    tok = torch.ones((1, 1), dtype=torch.int32, device=dev)
    out = []
    for t in range(8):
        logits, cache = M.decode_forward(
            cfg, params, cache, tok,
            torch.full((1,), t, dtype=torch.int32, device=dev))
        tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
        out.append(int(tok[0, 0]))
    print("greedy continuation:", out)
    print(f"checkpoints in {ckpt}")
    return out


if __name__ == "__main__":
    main()
