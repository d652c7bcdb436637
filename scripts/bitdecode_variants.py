#!/usr/bin/env python3
"""Time the port's low-bit decode attention (K3 ``bitdecode`` and K4
``paged_bitdecode``, ``src/repro_torch/csrc/``) against other versions of the
port's source tree, all on one card in one call.

    python3 scripts/bitdecode_variants.py
    python3 scripts/bitdecode_variants.py --tree parent=DIR   # DIR: another checkout

A tree is the root of a checkout (this one is "this"); each runs in a
process of its own against its own ``src/repro_torch`` (its own wrappers,
kernels and build directory), so versions with other C interfaces compare
as whole calls.  The trees' libraries are built at once, then every tree
is held against its plain version on a
few cases, then timed: device time of one whole call (the wrapper, the
kernel and, with splits, the merge), CUDA events around each call, L2
scrubbed before each, calls queued behind a spin kernel, at the decode
shapes of llama3-8b, gemma-7b and starcoder2-3b (K3: the dense loop's
cache; K4: the serve phase's pool and table).  The trees run in turns:
all of them, then all again in reverse order; both rounds are printed.
The bound is the bytes the call must move at 3.35 TB/s (H100 SXM).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HBM_BYTES_PER_S = 3.35e12
BN, BITS = 128, 4
PB_DENSE, RL_DENSE = [14, 15, 16, 16], [108, 80, 2, 52]     # llama3-8b's dense loop
PB_FAM, RL_FAM = [8, 8, 9, 9], [104, 56, 126, 48]          # gemma-7b, starcoder2-3b
PB_SERVE, RL_SERVE = [10, 20, 7, 13], [100, 60, 30, 90]    # a mid-run serve step
N_PAGES, NB_MAX = 4 * 32 + 4, 32
# name, paged, (B, H_kv, g, d, nb), pack_blocks, res_len
SHAPES = (
    ("K3 llama3-8b", False, (4, 8, 4, 128, 18), PB_DENSE, RL_DENSE),
    ("K3 gemma-7b", False, (4, 16, 1, 256, 11), PB_FAM, RL_FAM),
    ("K3 starcoder2-3b", False, (4, 2, 12, 128, 11), PB_FAM, RL_FAM),
    ("K4 llama3-8b", True, (4, 8, 4, 128, NB_MAX), PB_SERVE, RL_SERVE),
    ("K4 gemma-7b", True, (4, 16, 1, 256, NB_MAX), PB_SERVE, RL_SERVE),
    ("K4 starcoder2-3b", True, (4, 2, 12, 128, NB_MAX), PB_SERVE, RL_SERVE),
)


def call_bytes(b, h, g, d, pb, rl, paged):
    """What a call must move: the valid blocks' words and params, the valid
    residual tokens, q, the lengths (and table entries), the output."""
    npr = BN * BITS // 32
    blocks = sum(pb) * h
    return (blocks * (2 * npr * d * 4 + 2 * 2 * (d + BN)) + sum(rl) * h * 2 * d * 2
            + b * h * g * d * 2 + 8 * b + (4 * sum(pb) if paged else 0) + b * h * g * (d + 1) * 4)


def worker(tree: Path, extra: bool) -> int:
    """Parity and timing of one tree; prints one JSON line.  ``extra`` adds
    llama3-8b's K3 call with a warm L2, two calls back to back, at split
    counts 1 to 16, and on rows with no token (the call's fixed cost)."""
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch.kernels.bitdecode import ops as bd
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.paged_bitdecode import ops as pg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def inputs(paged, b, h, g, d, nb, pb, rl):
        v_off = 2.0 * torch.randn(d, generator=gen, device=dev)
        rows, n = (1, N_PAGES * BN) if paged else (b, nb * BN)
        kq_args = dict(block_n=BN, impl="torch")
        k = kq.quantize_kv(randn(rows, h, n, d), BITS, "channel", **kq_args)
        v = kq.quantize_kv((randn(rows, h, n, d) + v_off).to(torch.bfloat16), BITS, "tensor",
                           **kq_args)
        cache = [*k, *v]
        if paged:  # pools [P, H, ...] and a scrambled table over pages 4 ..
            cache = [x[0].movedim(1, 0).contiguous() for x in cache]
            cache.append((b + torch.randperm(N_PAGES - b, generator=gen, device=dev)[:b * nb])
                         .reshape(b, nb).to(torch.int32))
        res = [randn(b, h, BN, d), (randn(b, h, BN, d) + v_off).to(torch.bfloat16)]
        q = randn(b, h, g, d)
        if paged:
            return [q, *cache[:6], *res, cache[6], ints(pb), ints(rl)]
        return [q, *cache, *res, ints(pb), ints(rl)]

    def fn(paged, args, impl, **kw):
        f = pg.paged_bitdecode_attention if paged else bd.bitdecode_attention
        return f(*args, bits=BITS, block_n=BN, k_gran="channel", impl=impl, return_lse=True, **kw)

    scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

    def time_ms(f, iters=20, cold=True):
        f()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        pairs = []
        for _ in range(iters):
            if cold:
                scrub.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    result, bad = {}, 0
    for name, paged, (b, h, g, d, nb), pb, rl in SHAPES:
        args = inputs(paged, b, h, g, d, nb, pb, rl)
        out_r, lse_r = fn(paged, args, "torch", num_splits=1)
        for ns in (1, 3, "auto"):
            out_k, lse_k = fn(paged, args, "cuda", num_splits=ns)
            ok = (torch.allclose(out_k, out_r, rtol=2e-2, atol=2e-2)
                  and torch.allclose(lse_k, lse_r, rtol=1e-3, atol=1e-3))
            bad += not ok
            if not ok:
                print(f"  PARITY FAILED {tree.name} {name} num_splits={ns}", file=sys.stderr)
        result[name] = time_ms(lambda: fn(paged, args, "cuda")) * 1e3
        if name == "K3 llama3-8b" and extra:  # where the call's time goes
            result[name + ", L2 warm"] = time_ms(lambda: fn(paged, args, "cuda"), cold=False) * 1e3
            result[name + ", two calls"] = time_ms(
                lambda: (fn(paged, args, "cuda"), fn(paged, args, "cuda"))) * 1e3
            for ns in (1, 2, 4, 8, 16):
                result[f"{name}, num_splits={ns}"] = time_ms(
                    lambda: fn(paged, args, "cuda", num_splits=ns)) * 1e3
            empty = args[:-2] + [ints([0] * b), ints([0] * b)]  # the fixed cost
            for ns in (1, "auto"):
                result[f"{name}, empty rows, num_splits={ns}"] = time_ms(
                    lambda: fn(paged, empty, "cuda", num_splits=ns)) * 1e3
    print(json.dumps({"tree": str(tree), "us": result, "parity_failures": bad}), flush=True)
    return 1 if bad else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: the root of another version of the tree to time")
    parser.add_argument("--extra", action="store_true",
                        help="also time llama3-8b's K3 call with a warm L2 and at 1-16 splits")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(Path(args.worker), args.extra)
    import torch

    if not torch.cuda.is_available():
        print("bitdecode_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    trees = {"this": ROOT}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        trees[name] = Path(path).resolve()
    # build every tree's library at once (each build is one nvcc a source)
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.build()", str(path / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, path in trees.items()}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"  {name}: build failed\n{log[-3000:]}", flush=True)
            return 1
    times = {name: {} for name in trees}
    failed = 0
    order = list(trees)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            proc = subprocess.run([sys.executable, __file__, "--worker", str(trees[name])]
                                  + ["--extra"] * args.extra, capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                failed += 1
                print(f"  {name}: worker failed ({proc.returncode})", flush=True)
                continue
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            for shape, us in res["us"].items():
                times[name].setdefault(shape, []).append(us)
            print(f"  round {rnd + 1} {name}: " + ", ".join(
                f"{s} {us:.1f} us" for s, us in res["us"].items()), flush=True)
    rows = []
    for sname, paged, (b, h, g, d, nb), pb, rl in SHAPES:
        bound_us = call_bytes(b, h, g, d, pb, rl, paged) / HBM_BYTES_PER_S * 1e6
        for name in trees:
            us = times[name].get(sname, [])
            if not us:
                continue
            mean = sum(us) / len(us)
            rows.append(dict(shape=sname, tree=name, us=us, bound_us=bound_us,
                             share_of_bound=bound_us / mean))
            print(f"  {sname} {name}: {' / '.join(f'{x:.1f}' for x in us)} us, "
                  f"{bound_us / mean:.1%} of the {bound_us:.2f} us bound", flush=True)
    print(json.dumps({"bitdecode_variants": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
