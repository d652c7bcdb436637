#!/usr/bin/env python3
"""Time the port's residual-flush kernel (K2 ``residual_flush`` and K5
``paged_residual_flush``, ``src/repro_torch/csrc/residual_flush.cu``) against
other versions of its source, all in one process on one card.

    python3 scripts/flush_variants.py
    python3 scripts/flush_variants.py --variant old=OTHER/residual_flush.cu
    python3 scripts/flush_variants.py --ablate   # and the built source's ablations

Each other version keeps the C interface of ``residual_flush_launch``; it is
compiled by ``nvcc`` with the library's flags, against ``csrc/``, into a
library of its own under ``csrc/build/variants/``, and the port's wrappers
launch it in place of the built one.  Every library is first held against
the plain version, bit for bit, over 300 consecutive append steps (dense and
paged, d 128 and 256, a masked row).  Then, at llama3-8b's and gemma-7b's
decode caches (B 4, 4-bit, channel K; the dense loop's cache, the serve
pool behind a scrambled table): the append mode on a step where every row
flushes and on one where none does, and the flush mode alone on both,
device time of one call (CUDA events, L2 scrubbed before each call, calls
queued behind a spin kernel, the lengths reset before each, outside the
timed pair), beside an empty kernel (the launch floor).  The libraries run
in turns: all of them, then all again in reverse order; both rounds are
printed.

``--ablate`` adds versions of the built source with one part changed (see
ABLATIONS), written to ``csrc/build/variants/``: where a flush step's time
goes.  Those that change the results fail the parity check, and are timed
all the same.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

BN, BITS = 128, 4
N_PAGES, NB_MAX = 4 * 32 + 4, 32
# name, paged, H_kv, d
SHAPES = (("K2 llama3-8b", False, 8, 128), ("K2 gemma-7b", False, 16, 256),
          ("K5 llama3-8b", True, 8, 128), ("K5 gemma-7b", True, 16, 256))
_QUANT = "      float q = rintf(__fdiv_rn(__fsub_rn(x, z_sm[p]), s_sm[p]));"
# name -> (what it changes, text of residual_flush.cu, its replacement)
ABLATIONS = {
    "no_pack": ("no word packed (staging and statistics only; wrong results)",
                "for (int wi = tid; wi < nr * d; wi += FL_THREADS) {",
                "for (int wi = tid; wi < 0; wi += FL_THREADS) {"),
    "mul": ("a multiply in place of the division (wrong results)", _QUANT,
            _QUANT.replace("__fdiv_rn", "__fmul_rn")),
    "zero_skip": ("no division of a zero numerator", _QUANT,
                  "      const float num = __fsub_rn(x, z_sm[p]);\n"
                  "      float q = num == 0.0f ? 0.0f : rintf(__fdiv_rn(num, s_sm[p]));"),
    "ddiv": ("the division in double, rounded to float (exact: 53 >= 2 * 24 + 2 bits)", _QUANT,
             "      float q = rintf(__double2float_rn(__ddiv_rn((double)__fsub_rn(x, z_sm[p]), "
             "(double)s_sm[p])));"),
    "batch4": ("four 16-byte loads in flight a thread, not eight",
               "constexpr int FL_BATCH = 8;", "constexpr int FL_BATCH = 4;"),
}


def build_variant(name: str, src: str):
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib_{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o", str(so), src,
           str(_build.CSRC / "common.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def bind(so: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(so))
    fn_name, argtypes = _build._SIGNATURES["residual_flush"]
    getattr(lib, fn_name).argtypes, getattr(lib, fn_name).restype = argtypes, ctypes.c_int
    lib.repro_error_string.argtypes, lib.repro_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=FILE: another residual_flush.cu with the same C interface")
    parser.add_argument("--ablate", action="store_true",
                        help="also time the built source with each of ABLATIONS applied")
    args = parser.parse_args()
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.kv_quant import ops as kq
    from repro_torch.kernels.residual_flush import ops as rf

    if not torch.cuda.is_available():
        print("flush_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = {"built": _build.build()}
    jobs = {}
    specs = [spec.partition("=")[::2] for spec in args.variant]
    if args.ablate:
        out = _build.BUILD_DIR / "variants"
        out.mkdir(parents=True, exist_ok=True)
        text = (_build.CSRC / "residual_flush.cu").read_text()
        for name, (what, old, new) in ABLATIONS.items():
            if text.count(old) != 1:
                print(f"ablation {name}: the text to replace is not in the source once",
                      file=sys.stderr)
                return 1
            (out / f"{name}.cu").write_text(text.replace(old, new))
            specs.append((name, str(out / f"{name}.cu")))
            print(f"  ablation {name}: {what}", flush=True)
    for name, src in specs:
        jobs[name] = build_variant(name, src)
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"variant {name} failed to build:\n{log}", file=sys.stderr)
            return 1
        libs[name] = bind(so)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def ints(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    def state(paged, b, h, d, nb, pb):
        rows, n = (1, N_PAGES * BN) if paged else (b, nb * BN)
        arrays = [*kq.quantize_kv(randn(rows, h, n, d), BITS, "channel", block_n=BN),
                  *kq.quantize_kv(randn(rows, h, n, d), BITS, "tensor", block_n=BN)]
        if paged:
            arrays = [x[0].movedim(1, 0).contiguous() for x in arrays]
        arrays += [randn(b, h, BN, d), randn(b, h, BN, d)]
        lens = [ints(pb), ints([0] * b), ints([0] * b)]
        if paged:
            table = (b + torch.randperm(N_PAGES - b, generator=gen, device=dev)[:b * NB_MAX])
            lens.insert(0, table.reshape(b, NB_MAX).to(torch.int32))
        return arrays, lens

    def new_tokens(b, h, d):  # the model's strided views
        return (randn(b, 1, h, d).transpose(1, 2),
                randn(b, 1, 2 * h, d)[:, :, h:].transpose(1, 2))

    kw = dict(bits=BITS, block_n=BN, k_gran="channel")
    bad = 0
    for name, lib in libs.items():
        for paged in (False, True):
            for h, d in ((8, 128), (16, 256)):
                _build._lib = libs["built"]  # the state's packing is K1's
                arrays, lens = state(paged, 4, h, d, 6, [0, 1, 0, 2])
                _build._lib = lib
                lens[-2].copy_(ints([5, 60, 127, 90]))
                twin = [x.clone() for x in arrays + lens]
                fn = rf.paged_append_flush if paged else rf.append_flush
                same = True
                for step in range(300):
                    mask = torch.tensor([True, True, True, step % 4 != 3], device=dev)
                    k_new, v_new = new_tokens(4, h, d)
                    fn(*arrays, k_new, v_new, *lens, mask=mask, impl="cuda", **kw)
                    fn(*twin[:8], k_new, v_new, *twin[8:], mask=mask, impl="torch", **kw)
                    same = same and all(torch.equal(x, y) for x, y in zip(arrays + lens, twin))
                if not same:
                    bad += 1
                    print(f"  PARITY FAILED {name} paged={paged} d={d}", file=sys.stderr)
    _build._lib = libs["built"]

    scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

    def time_ms(f, prep=lambda: None, iters=20):
        prep()
        f()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        pairs = []
        for _ in range(iters):
            scrub.zero_()
            prep()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    calls = {}
    for sname, paged, h, d in SHAPES:
        pb = [10, 20, 7, 13] if paged else [14, 15, 16, 16]
        arrays, lens = state(paged, 4, h, d, 18, pb)
        k_new, v_new = new_tokens(4, h, d)
        append = rf.paged_append_flush if paged else rf.append_flush
        flush = rf.paged_residual_flush if paged else rf.residual_flush
        for rl, what in ((BN - 1, "flush step"), (5, "no flush")):
            def prep(rl=rl, pb=ints(pb), lens=lens):
                lens[-3].copy_(pb)
                lens[-2].fill_(rl)
            calls[f"{sname} append, {what}"] = (
                lambda a=arrays, l_=lens, f=append, kn=k_new, vn=v_new: f(*a, kn, vn, *l_,
                                                                          impl="cuda", **kw),
                prep)
            full = ints([int(rl == BN - 1)] * 4)
            dest = (lens[0][:, 12].contiguous() if rl == BN - 1 else ints([0, 1, 2, 3])
                    ) if paged else ints(pb)
            calls[f"{sname} flush mode, {what}"] = (
                lambda a=arrays, f=flush, fu=full, de=dest: f(*a, fu, de, impl="cuda", **kw),
                lambda: None)
    times = {name: {} for name in libs}
    order = list(libs)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            _build._lib = libs[name]
            res = {"launch floor": time_ms(lambda: torch.cuda._sleep(0)) * 1e3}
            for what, (f, prep) in calls.items():
                res[what] = time_ms(f, prep) * 1e3
            for what, us in res.items():
                times[name].setdefault(what, []).append(us)
            print(f"  round {rnd + 1} {name}: " + ", ".join(f"{w} {us:.1f}" for w, us in res.items()),
                  flush=True)
    _build._lib = libs["built"]
    for name, res in times.items():
        for what, us in res.items():
            print(f"  {name}: {what} {' / '.join(f'{x:.1f}' for x in us)} us", flush=True)
    print(json.dumps({"flush_variants": times, "parity_failures": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
