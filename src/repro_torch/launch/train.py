"""Training launcher: square-routed training on the GPU, each step replayed
from one CUDA graph.

    python -m repro_torch.launch.train --arch fairsquare-demo \\
        --matmul-mode square_pallas --steps 200 --global-batch 8 --seq 256 \\
        --ckpt-dir ckpt

trains the paper's model at full width (random weights from seed 0, the
JAX launcher's defaults: 8 sequences of 256 tokens a step, the config's
own dtype and ``remat``) on the synthetic pipeline, with AdamW, periodic
atomic checkpoints and the fault-tolerant :class:`Trainer`; it resumes
from the newest valid checkpoint in ``--ckpt-dir``.  Under
``square_pallas`` every contraction, forward and both gradients, runs on
K1 (projections, FFN, gates, loss) or K2/K3 (attention, the xLSTM state
mixes).  On CUDA the step is
captured whole (forward, backward, AdamW) into a CUDA graph at its first
call and replayed after (:func:`repro_torch.train.step.jit_train_step`,
the JAX launcher's ``jax.jit(make_train_step(...), donate_argnums=(0,
1))``); a new input signature captures again (``--grad-compression``
does once, after its first step), and the count of captures is printed
and returned under ``"captures"``.  ``--reduced`` trains the small smoke
configuration and ``--layers N`` the first N layers of the arch at its
width (recurrentgemma-2b's whole captured step does not fit one 80 GB
card); ``--device cpu`` runs the step eagerly on the kernels'
plain versions, as the CPU has no graphs.  ``--metrics-file`` writes the
trainer's registry snapshot (step counters and percentiles, checkpoint
commits, the first step's contraction audit: on CUDA the compiled audit
of its replay) as JSON and ``--trace-out`` a Chrome trace of the run.
:func:`main` returns the trainer's result dict.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import List, Optional

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.lm import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import write_chrome_trace
from repro_torch.optim import adamw
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fairsquare-demo")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--matmul-mode", default=None)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale reduction of --arch")
    ap.add_argument("--layers", type=int, default=0,
                    help="train only the first N layers of --arch, at its "
                         "width (a depth cut, for an arch whose whole "
                         "captured step does not fit the card)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--metrics-file", default=None,
                    help="write the trainer's registry snapshot (step "
                         "counters and percentiles, checkpoint commits, "
                         "contraction audit) as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="trace the run and write a Chrome trace_event JSON "
                         "(Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)
    tracing = (obs_trace.capture() if args.trace_out
               else contextlib.nullcontext())
    with tracing as tracer:
        out = _train(args)
        if tracer is not None:
            write_chrome_trace(tracer, args.trace_out)
            print(f"trace -> {args.trace_out} ({len(tracer.records())} "
                  f"records, {tracer.dropped} dropped)")
    return out


def _train(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.matmul_mode:
        cfg = dataclasses.replace(cfg, matmul_mode=args.matmul_mode)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=args.device, seed=0)
    params = model.train_params()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params:,} "
          f"mode={cfg.matmul_mode} dtype={cfg.dtype} remat={cfg.remat} "
          f"device={model.device}")
    opt_state = adamw.adamw_init(params)
    tcfg = step_mod.TrainConfig(
        opt=adamw.AdamWConfig(lr=args.lr,
                              warmup_steps=max(10, args.steps // 20),
                              total_steps=args.steps),
        microbatch=args.microbatch,
        grad_compression=args.grad_compression)
    train_step = step_mod.make_train_step(model, tcfg)
    if model.device.type == "cuda":
        train_step = step_mod.jit_train_step(train_step, model.device)
    data = SyntheticLM(DataConfig(global_batch=args.global_batch,
                                  seq_len=args.seq, vocab=cfg.vocab), cfg,
                       device=model.device)
    trainer = Trainer(TrainerConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every,
                                    ckpt_dir=args.ckpt_dir),
                      train_step, params, opt_state, data)
    if trainer.maybe_resume():
        print(f"resumed from step {trainer.step}")
    out = trainer.run()
    for m in out["metrics"][-5:]:
        print({k: round(v, 4) if isinstance(v, float) else v
               for k, v in m.items()})
    print(f"done at step {out['final_step']} (captures: "
          f"{out['captures']}, stragglers observed: "
          f"{len(out['stragglers'])})")
    if args.metrics_file:
        with open(args.metrics_file, "w") as f:
            json.dump(trainer.obs_snapshot(), f, indent=1, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_file}")
    return out


if __name__ == "__main__":
    main()
