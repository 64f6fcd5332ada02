"""End-to-end driver, the port of ``examples/train_100m.py``: train a
~100M-parameter llama-family model on the deterministic Markov corpus
with the full production loop (async checkpointing, fault-tolerant
restart, straggler watchdog).

Full run (a few hundred steps, ~100M params):
    PYTHONPATH=src python -m repro_torch.launch.train_100m --steps 300
CI-scale run:
    PYTHONPATH=src python -m repro_torch.launch.train_100m --smoke \
        --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; there every attention
forward is the flash kernel's tensor-core branch (bf16, hd 64, 10 query
heads over 5 KV heads).  ``--ckpt-every`` overrides the reference's
checkpoint interval, ``max(steps // 5, 10)``.  The run fails unless the
last logged loss is below the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Optional

from repro_torch.configs import ArchConfig, ShapeSpec, get_config
from repro_torch.data import MarkovChainData
from repro_torch.device import DeviceLike
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def model_100m() -> ArchConfig:
    """~100M params: 10L, d=640, ff=2560, 10 heads (kv 5), vocab 50304."""
    return dataclasses.replace(
        get_config("yi-6b"),
        name="llama-100m",
        num_layers=10, d_model=640, num_heads=10, num_kv_heads=5,
        head_dim=64, d_ff=2560, vocab_size=50304, loss_chunk=128,
    )


def smoke_config() -> ArchConfig:
    """``--smoke``'s reduction of :func:`model_100m`."""
    return dataclasses.replace(model_100m(), num_layers=2, d_model=128,
                               num_heads=4, num_kv_heads=2, head_dim=32,
                               d_ff=512, vocab_size=1024)


#: ``--smoke``'s steps, batch and sequence length
SMOKE_RUN = (30, 4, 64)


def param_estimate(cfg: ArchConfig) -> int:
    """The reference's estimate: attention, MLP and the two embeddings."""
    return (cfg.num_layers *
            (2 * cfg.d_model * cfg.num_heads * cfg.resolved_head_dim +
             2 * cfg.d_model * cfg.num_kv_heads * cfg.resolved_head_dim
             + 3 * cfg.d_model * cfg.d_ff) +
            2 * cfg.vocab_size * cfg.d_model)


def run(cfg: ArchConfig, steps: int, batch: int, seq: int,
        ckpt: Optional[str] = None, ckpt_every: Optional[int] = None,
        device: DeviceLike = None) -> dict:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` through
    ``Trainer.run_with_recovery`` and print the reference's report; the
    trainer's result (``ckpt``: the checkpoint directory)."""
    print(f"model ~{param_estimate(cfg)/1e6:.0f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq}")
    shape = ShapeSpec("train_cfg", seq, batch, "train")
    data = MarkovChainData(cfg, shape, seed=0)
    ckpt = ckpt or tempfile.mkdtemp(prefix="train100m_ckpt_")
    trainer = Trainer(cfg, shape, data,
                      TrainerConfig(total_steps=steps,
                                    ckpt_every=ckpt_every
                                    or max(steps // 5, 10),
                                    ckpt_dir=ckpt,
                                    log_every=max(steps // 20, 1)),
                      device=device)
    res = trainer.run_with_recovery()
    first, last = res["metrics"][0], res["metrics"][-1]
    print(f"\nloss {first['loss']:.4f} -> {last['loss']:.4f} over "
          f"{res['final_step']} steps "
          f"({len(res['stragglers'])} straggler flags, "
          f"{res['restarts']} restarts)")
    for m in res["metrics"]:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['step_s']*1e3:.0f} ms/step")
    if not last["loss"] < first["loss"]:
        raise RuntimeError(f"loss must decrease: {first['loss']} -> "
                           f"{last['loss']}")
    print(f"checkpoints committed under {ckpt}")
    return dict(res, ckpt=ckpt)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="steps between checkpoints (default: the "
                         "reference's max(steps // 5, 10))")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.smoke:
        cfg = smoke_config()
        args.steps, args.batch, args.seq = SMOKE_RUN
    else:
        cfg = model_100m()
    return run(cfg, args.steps, args.batch, args.seq, args.ckpt,
               args.ckpt_every, args.device)


if __name__ == "__main__":
    main()
