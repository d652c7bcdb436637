#!/usr/bin/env python3
"""How far zamba2-7b's Mamba2 states drift between runs that differ only by
rounding, at full width and at chip_smoke's depth (``chip_smoke.HYBRID_LAYERS``
of its 81 layers; ``--layers 81`` for the full depth) on one card: the
evidence for ``chip_smoke.SSM_SPREAD``.

    python3 scripts/hybrid_ssm_spread.py
    python3 scripts/hybrid_ssm_spread.py --seeds 1 2 3

For each prompt seed, four prompts of ``chip_smoke.HYBRID_PROMPT`` tokens
(random weights from chip_smoke's seed) are prefilled and decoded for
``chip_smoke.HYBRID_STEPS`` greedy steps on the plain versions; then, fed
the plain run's tokens, on the kernels, on the plain versions split three
ways along the cache and, for the first seed, on the plain versions with
the prefill's attention in 256-key blocks (split three ways) and on the
kernels split three ways.  Prints each run's SSM states' relative-norm
gap from the plain run's (and that of the prefill alone) with its largest
logit difference, the card's name and power limit, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2],
                    help="prompt seeds (chip_smoke's dense loop uses 1)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: chip_smoke.HYBRID_LAYERS)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("hybrid_ssm_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.models.zoo import build_model

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg, model, params, _ = cs.build_random(cs.HYBRID, dev,
                                            n_layers=args.layers or cs.HYBRID_LAYERS)
    m256 = build_model(cfg.with_(attn_block_k=256))
    side = [p for p, _ in model.paged_spec().side_state]
    prompt, steps = cs.HYBRID_PROMPT, cs.HYBRID_STEPS

    def gap(st, ref):
        return {p: ((st[p]["ssm"] - ref[p]["ssm"]).norm() / ref[p]["ssm"].norm()).item()
                for p in side}

    out = {}
    with torch.no_grad():
        for i, seed in enumerate(args.seeds):
            tok = torch.randint(0, cfg.vocab, (4, prompt), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(seed))
            pre = {lab: m.prefill(params, {"tokens": tok}, prompt + steps, impl=impl,
                                  quant_impl=impl)[1]
                   for lab, m, impl in (("plain", model, "torch"), ("kernels", model, "auto"),
                                        ("plain_bk256", m256, "torch"))}
            for lab in ("kernels", "plain_bk256"):
                out[f"seed {seed}, prefill, {lab}"] = gap(pre[lab], pre["plain"])
            del pre
            lg_p, st_p, *_ = cs.decode_run(model, params, tok, None, steps, "torch")
            feed = list(lg_p[:-1].argmax(-1)[:, :, None])
            runs = [("kernels", model, "auto", "auto"), ("plain_split3", model, "torch", 3)]
            if i == 0:
                runs += [("plain_bk256_split3", m256, "torch", 3),
                         ("kernels_split3", model, "auto", 3)]
            for lab, m, impl, ns in runs:
                lg, st, *_ = cs.decode_run(m, params, tok, None, steps, impl, num_splits=ns,
                                           feed=feed)
                key = f"seed {seed}, {steps} steps, {lab}"
                out[key] = gap(st, st_p) | {"max_dlogit": (lg - lg_p).abs().max().item()}
                print(key, {k: f"{v:.3e}" for k, v in out[key].items()}, flush=True)
                del lg, st
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: not available")
    print(json.dumps({"layers": cfg.n_layers, "ssm_rel_gap": out,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
