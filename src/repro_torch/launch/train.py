"""Training launcher of the port: the JAX package's ``launch/train.py`` on
one device (same arguments, same output lines, plus ``--device``).

Usage (the smoke config on the CPU; on the card drop ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \\
      --steps 4 --batch 8 --seq 32 --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded 0 on the
run's device; the data is the synthetic pipeline (``data/pipeline.py``),
made ahead on a background thread.  A checkpoint is saved every
``--ckpt-every`` steps (on a thread) and at the end; ``--resume`` starts
from the latest one.  A step that raises is retried from the latest
checkpoint, at most ``--max-failures`` times: the state is restored and the
data restarts at the restored step, so the batch of step s is always the
batch of step s and a run that rolls back ends where an uninterrupted run
ends (the JAX launcher's prefetcher runs on past a rollback: ROADMAP C).
``--batch`` must be a multiple of the config's ``microbatches``.

A run across ranks (``--model-parallel`` other than 1, FSDP / TP
placements) is not ported: ROADMAP queue A, item 12.5.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeSpec, get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import Prefetcher
from repro_torch.models.zoo import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import init_train_state, make_train_step

_MULTI_RANK = "ROADMAP queue A, item 12.5 (training across ranks)"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="'cpu', or the card (default)")
    return ap


@dataclasses.dataclass
class StepRecord:
    step: int  # the step count after it
    loss: float
    grad_norm: float
    seconds: float  # its wall time, the device synchronized


def train_loop(model, optimizer, state, shape, *, steps: int, device, mgr=None,
               ckpt_every: int = 20, max_failures: int = 3, log_every: int = 10,
               fail_step: int | None = None):
    """Train ``state`` from its step up to ``steps``; returns ``(state,
    [StepRecord per completed step])``.  With ``mgr`` a checkpoint is saved
    every ``ckpt_every`` steps (``save_async``) and at the end, and a failed
    step rolls back to the latest one (data restarted there); without it a
    failure raises.  ``fail_step``: the step at which to raise once (a
    transient fault, for tests and ``chip_smoke.py``)."""
    cfg = model.cfg
    train_step = make_train_step(model, optimizer, microbatches=cfg.microbatches)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    step = state.step
    pre = Prefetcher(cfg, shape, device=device, start_step=step)
    failures, records, t_run = 0, [], time.time()
    try:
        while step < steps:
            data_step, batch = pre.next()
            assert data_step == step, (data_step, step)
            t0 = time.time()
            try:
                if step == fail_step:
                    fail_step = None
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = train_step(state, batch)
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            except Exception as e:  # a transient failure: roll back
                failures += 1
                print(f"[train] step {step} failed ({e!r}); failure {failures}/{max_failures}")
                if mgr is None or failures > max_failures or mgr.latest_step() is None:
                    raise
                mgr.wait()
                state, step = mgr.restore(None, state)
                pre.close()
                pre = Prefetcher(cfg, shape, device=device, start_step=step)
                print(f"[train] rolled back to step {step}")
                continue
            sync()
            step += 1
            records.append(StepRecord(step, loss, gnorm, time.time() - t0))
            if step % log_every == 0:
                dt = (time.time() - t_run) / len(records)
                print(f"[train] step {step} loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"{dt * 1e3:.0f} ms/step")
            if mgr is not None and step % ckpt_every == 0:
                mgr.save_async(step, state)
        if mgr is not None:
            mgr.save(step, state)
    finally:
        pre.close()
        if mgr is not None:
            mgr.wait()
    return state, records


def run(argv=None, *, fail_step: int | None = None):
    """Parse ``argv`` and train; returns ``(state, records)`` as
    :func:`train_loop`.  ``fail_step`` as there (not a flag)."""
    args = _parser().parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: training across ranks is not ported "
            f"yet: {_MULTI_RANK}")
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    optimizer = get_optimizer(cfg.optimizer, total_steps=args.steps)
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(model, optimizer, gen, device)
    if args.resume and mgr.latest_step() is not None:
        state, start = mgr.restore(None, state)
        print(f"[train] resumed from step {start}")
    state, records = train_loop(model, optimizer, state, shape, steps=args.steps,
                                device=device, mgr=mgr, ckpt_every=args.ckpt_every,
                                max_failures=args.max_failures, log_every=args.log_every,
                                fail_step=fail_step)
    last = f"{records[-1].loss:.4f}" if records else "n/a"
    print(f"[train] done at step {state.step}; final loss {last}")
    return state, records


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
