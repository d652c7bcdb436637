#!/usr/bin/env python3
"""How far a smoke model's gradient leaves move between the card and the
CPU, beside how far each moves under rounding-level changes of its inputs:
the evidence for ``chip_smoke.GRAD_WITNESSED``, the one leaf held past
``chip_smoke.TRAIN_GRAD_REL_L2``.

    python3 scripts/train_grad_spread.py                      # zamba2-7b smoke
    python3 scripts/train_grad_spread.py --seeds 0 1 2 3 --arch deepseek-v3-671b
    python3 scripts/train_grad_spread.py --device cpu         # the CPU's columns

For each seed s the smoke model's parameters are drawn on the CPU from seed
s and the batch is ``make_batch``'s step s + 3 (seed 0 is phase 14 (C)'s
draw: parameters from 0, step 3), B 2 x 32.  The loss and every gradient
leaf are computed on the CPU and on the card from the same parameters, and
again with one bf16 ulp added to every 101st (``chip_smoke.ulp_nudged``)
and to every 13th parameter.  For each leaf: the card-vs-CPU relative L2
gap and each device's two witnesses (relative L2 from its own unnudged
gradient).  Prints the named leaf's row and the worst other leaf's at each
seed, the card's name and power limit, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--leaf", default=None,
                    help="the leaf to report (default: chip_smoke.GRAD_WITNESSED's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the CPU's columns alone")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.zoo import build_model
    from repro_torch.train import tree as tr
    from repro_torch.train.step import value_and_grad

    if args.device == "cuda" and not torch.cuda.is_available():
        print("train_grad_spread: no CUDA device (--device cpu for the CPU's columns)",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke runs
    torch.backends.cudnn.allow_tf32 = False
    leaf = args.leaf or dict(cs.GRAD_WITNESSED).get(args.arch)
    t0 = time.perf_counter()
    cfg = smoke_config(args.arch)
    model = build_model(cfg)
    dev = torch.device(args.device)
    rows = []
    for seed in args.seeds:
        cpu = model.init(torch.Generator().manual_seed(seed), "cpu")
        batch = make_batch(cfg, ShapeSpec("t", 32, 2, "train"), step=seed + 3, device="cpu")
        names = [".".join(map(str, p)) for p, _ in tr.leaves_with_paths(cpu)]

        def grads(params, on):
            b = {k: v.to(on) for k, v in batch.items()}
            out = [value_and_grad(model.loss, params, b)[1]]
            for every in cs.GRAD_NUDGES:
                out.append(value_and_grad(
                    model.loss, tr.map_leaves(lambda t: cs.ulp_nudged(t, every), params), b)[1])
            return [[g.float().cpu() for g in gs] for gs in out]

        g_c = grads(cpu, "cpu")
        g_d = grads(tr.map_leaves(lambda t: t.to(dev), cpu), dev) if dev.type == "cuda" else None
        per_leaf = {}
        for i, name in enumerate(names):
            rec = {f"cpu_w{n}": cs._rel_l2(g_c[j + 1][i], g_c[0][i])
                   for j, n in enumerate(cs.GRAD_NUDGES)}
            if g_d is not None:
                rec["gap"] = cs._rel_l2(g_d[0][i], g_c[0][i])
                rec |= {f"card_w{n}": cs._rel_l2(g_d[j + 1][i], g_d[0][i])
                        for j, n in enumerate(cs.GRAD_NUDGES)}
            per_leaf[name] = rec
        key = "gap" if g_d is not None else f"cpu_w{cs.GRAD_NUDGES[0]}"
        others = {n: r for n, r in per_leaf.items() if n != leaf}
        worst = max(others, key=lambda n: others[n][key])
        row = {"seed": seed, "leaf": per_leaf.get(leaf), "worst_other": worst,
               "worst_other_rec": others[worst]}
        rows.append(row)
        fmt = lambda r: ", ".join(f"{k} {v:.2e}" for k, v in r.items())  # noqa: E731
        print(f"seed {seed}: {leaf}: {fmt(row['leaf']) if row['leaf'] else 'absent'}; "
              f"worst other leaf by {key} {worst}: {fmt(others[worst])}", flush=True)
    if leaf and all(r["leaf"] for r in rows) and g_d is not None:
        over = [r["seed"] for r in rows
                if r["leaf"]["gap"] > max(v for k, v in r["leaf"].items() if "_w" in k)]
        print(f"{leaf}: gap {min(r['leaf']['gap'] for r in rows):.2e}-"
              f"{max(r['leaf']['gap'] for r in rows):.2e} over {len(rows)} seeds; past its "
              f"largest witness at seeds {over or 'none'}; other leaves' worst gap "
              f"{max(r['worst_other_rec']['gap'] for r in rows):.2e}")
    if dev.type == "cuda":
        print(cs.gpu_name_power())
    print(json.dumps({"arch": args.arch, "leaf": leaf, "nudges": cs.GRAD_NUDGES, "rows": rows,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
