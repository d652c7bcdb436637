#!/usr/bin/env python3
"""Hold the async runtime's captured decode step (one CUDA graph replay)
against the same step run eagerly, at a model's full width, on one card.

    python3 scripts/captured_step_profile.py
    python3 scripts/captured_step_profile.py --arch gemma-7b --layers 28

A ``ServeEngine(async_runtime=True)`` (4 slots, max_seq 4096, 4-bit
channel-wise K, ``kv_block`` 128, random weights from a seed) admits four
prompts of 900-1,200 tokens and runs six cycles.  Then, from the same
saved state: one eager run of the captured body and one replay, every
state tensor and the argmax compared bit for bit; then ``--repeats`` rounds
of one replay and one eager run under ``torch.profiler`` (CPU and CUDA
activities, each a session of its own), each round's device-kernel count
and kernel time, and the kernel names whose counts differ between the two
(a copy is a ``Memcpy DtoD`` eagerly and a ``memcpy32_post`` kernel node in
the graph, a memset's device shows as ``Unknown`` in a graph).  Last, the
wall time of ``--steps`` replays against as many eager steps, each ending
in a synchronise.  Prints the card's name and power limit and one JSON
line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def device_kernels(fn) -> tuple[collections.Counter, float]:
    """Device events of one call of ``fn`` by name, and their ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names, us = collections.Counter(), 0.0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            names[ev.key] += ev.count
            t = getattr(ev, "self_device_time_total", None)
            us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
    return names, us / 1e3


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: full)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("captured_step_profile: no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.configs import get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.async_runtime import _state_tensors

    change = {} if args.layers is None else {"n_layers": args.layers}
    cfg = get_config(args.arch).with_(kv_bits=4, kv_block=128, kv_gran="channel", **change)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    eng = ServeEngine(model, params, slots=4, max_seq=4096, async_runtime=True)
    rng = np.random.default_rng(0)
    for uid in range(4):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, cfg.vocab, 900 + 100 * uid)
                           .astype(np.int32), max_new_tokens=200))
    for _ in range(6):
        eng.step()
    torch.cuda.synchronize()
    step = eng._runner.step_fn
    saved = [t.clone() for t in _state_tensors(eng.state)] + [step.tokens.clone()]

    def restore():
        for t, s in zip([*_state_tensors(eng.state), step.tokens], saved):
            t.copy_(s)

    def outputs():
        return [t.clone() for t in (*_state_tensors(eng.state), step.nxt, step.finite,
                                    step.tokens)]

    with torch.no_grad():
        step._body()
    eager = outputs()
    restore()
    step.graph.replay()
    graphed = outputs()
    bitwise = all(torch.equal(a, b) for a, b in zip(eager, graphed))
    print(f"{cfg.name}, {cfg.n_layers} layers: one replay equals one eager step bit for bit: "
          f"{bitwise}", flush=True)

    rounds = []
    for i in range(args.repeats):
        restore()
        r_names, r_ms = device_kernels(step.graph.replay)
        restore()
        e_names, e_ms = device_kernels(step._body)
        differ = {k: [r_names[k], e_names[k]] for k in sorted(set(r_names) | set(e_names))
                  if r_names[k] != e_names[k]}
        rounds.append({"replay_kernels": sum(r_names.values()), "replay_ms": r_ms,
                       "eager_kernels": sum(e_names.values()), "eager_ms": e_ms,
                       "names_differ": differ})
        print(f"  round {i}: replay {rounds[-1]['replay_kernels']} device kernels, "
              f"{r_ms:.3f} ms; eager {rounds[-1]['eager_kernels']}, {e_ms:.3f} ms; "
              f"names whose counts differ (replay, eager): {differ}", flush=True)

    wall = {}
    for how, fn in (("replay", step.graph.replay), ("eager", step._body),
                    ("replay_again", step.graph.replay)):
        restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(args.steps):
                fn()
        torch.cuda.synchronize()
        wall[how] = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"  wall ms a step over {args.steps} steps: {wall}", flush=True)
    eng.close()
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
    print(power)
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers, "bitwise": bitwise,
                      "rounds": rounds, "wall_ms_per_step": wall, "card": power}))
    return 0 if bitwise else 1


if __name__ == "__main__":
    sys.exit(main())
