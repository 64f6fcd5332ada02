"""Training launcher, the port of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch gemma2-2b --smoke --steps 20 \
        --device cpu

Runs the full loop (``Trainer.run_with_recovery``: async checkpoints,
restart on failure, straggler watchdog) on ``cuda`` unless ``--device
cpu`` is given.  Data is sharded per host by ``--host-id`` /
``--num-hosts``.  The reference's ``--profile`` has no counterpart: the
trainer runs without a mesh, where a sharding profile changes nothing.
The sharded step and its dry-run over a production mesh are
``models.steps.lowerable`` and ``python -m repro_torch.launch.dryrun
--profile``.
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import SHAPES, get_config, smoke_shape
from repro_torch.data import MarkovChainData, SyntheticLMData
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny batch (CPU-sized)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data", choices=["markov", "uniform"], default="markov")
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        shape = smoke_shape("train")
    else:
        shape = SHAPES[args.shape]
        assert shape.kind == "train", "use serve.py for inference shapes"

    data_cls = MarkovChainData if args.data == "markov" else SyntheticLMData
    data = data_cls(cfg, shape, seed=0, num_hosts=args.num_hosts,
                    host_id=args.host_id)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix=f"{args.arch}_ckpt_")
    trainer = Trainer(
        cfg, shape, data,
        TrainerConfig(total_steps=args.steps,
                      ckpt_every=max(args.steps // 5, 5),
                      ckpt_dir=ckpt, log_every=max(args.steps // 20, 1)),
        opt_cfg=AdamWConfig(warmup_steps=min(100, args.steps // 3 or 1),
                            total_steps=args.steps),
        compress=args.compress_grads, device=args.device)
    res = trainer.run_with_recovery()
    for m in res["metrics"]:
        print(f"step {m['step']:6d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
              f"{m['step_s']*1e3:.0f} ms")
    print(f"done: {res['final_step']} steps, {res['restarts']} restarts, "
          f"{len(res['stragglers'])} straggler flags; checkpoints: {ckpt}")
    return res


if __name__ == "__main__":
    main()
