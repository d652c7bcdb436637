#!/usr/bin/env python3
"""Time the port's prefill quantize kernel (K1 ``kv_quant``,
``src/repro_torch/csrc/kv_quant.cu``) and the cache fill around it, against
other versions of the port's tree and of its source, all on one card in one
call.

    python3 scripts/kv_quant_variants.py
    python3 scripts/kv_quant_variants.py --tree parent=DIR   # DIR: another checkout
    python3 scripts/kv_quant_variants.py --ablate            # and the source's ablations
    python3 scripts/kv_quant_variants.py --variant old=FILE  # another kv_quant.cu

A tree is the root of a checkout (this one is "this"); each runs in a
process of its own against its own ``src/repro_torch``, so versions with
other C interfaces compare through their Python entry points.  ``--ablate``
adds versions of this tree's ``kv_quant.cu`` with one part changed (see
ABLATIONS), and ``--variant`` other sources with the same C interface; each
is compiled with the library's flags, against ``csrc/``, into
``csrc/build/variants/`` and run in this tree's code in place of the built
library.  Every version is first held against the plain version, bit for
bit (ablations that change the results fail this and are timed all the
same).

Timed at llama3-8b's prefill (B 4, H_kv 8, 2,048 packed tokens of a
2,100-token prompt, d 128) and gemma-7b's (B 4, H_kv 16, 1,152 of 1,200,
d 256), 4-bit, 128-token blocks, K and V as the model's strided views:
K alone (params per channel, fresh outputs), V alone (per token), the
layer's cache fill as the tree's ``qcache._quantize_full_region`` does it
(this tree: the pair in one launch; the parent: two launches and six slice
copies), and in this tree also the pair through ``quantize_kv_pair``, the
two tensors as two launches into the cache (``out=``), and the parent's
fill (two launches into fresh outputs, six copies); an empty kernel is the
launch floor.  Device time of one call: CUDA events around it, L2 scrubbed
before each (a 64 MB buffer written, as chip_smoke.py does), calls queued
behind a spin kernel.  Versions run in turns: all
of them, then all again in reverse order; both rounds are printed.  The
bound is the bytes a call must move at 3.35 TB/s (H100 SXM).
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
# name, (B, H_kv, prompt tokens, d)
SHAPES = (("llama3-8b", (4, 8, 2100, 128)), ("gemma-7b", (4, 16, 1200, 256)))
_QUANT = "        float q = __fdiv_rn(nil ? sc : num, sc);"
# name -> (what it changes, text of kv_quant.cu, its replacement)
ABLATIONS = {
    "no_div": ("a multiply in place of the division (wrong results)", _QUANT,
               _QUANT.replace("__fdiv_rn", "__fmul_rn")),
    "div_zero": ("zero numerators divided too (their range check takes the slow path)",
                 _QUANT, "        float q = __fdiv_rn(num, sc);"),
    "no_pack": ("no word packed (staging, statistics and params only; wrong results)",
                "for (int it = threadIdx.x; it < n.nr * G; it += KQ_THREADS) {",
                "for (int it = threadIdx.x; it < 0; it += KQ_THREADS) {"),
    "min2": ("registers sized for 2 CTAs an SM, not 3", "constexpr int KQ_MIN_CTAS = 3;",
             "constexpr int KQ_MIN_CTAS = 2;"),
    "batch4": ("units of 16 KB (4 copies a thread), twice as many",
               "constexpr int KQ_BATCH = 8; ", "constexpr int KQ_BATCH = 4; "),
}


def nbytes(b, h, n, d, channel):
    """What quantizing n tokens of one tensor must move: the bf16 input, the
    4-bit words, the bf16 scale and zero."""
    return b * h * n * d * 2 + b * h * n * d * BITS // 8 + 2 * 2 * b * h * (n // BN) * (
        d if channel else BN)


def worker(tree: Path, lib: str | None) -> int:
    """Parity and timing of one version; prints one JSON line."""
    sys.path.insert(0, str(tree / "src"))
    import ctypes

    import torch

    from repro_torch.core import qcache
    from repro_torch.kernels import _build
    from repro_torch.kernels.kv_quant import ops as kq

    if lib:  # an ablation: this tree's code on another build of its source
        so = ctypes.CDLL(lib)
        fn_name, argtypes = _build._SIGNATURES["kv_quant"]
        getattr(so, fn_name).argtypes, getattr(so, fn_name).restype = argtypes, ctypes.c_int
        so.repro_error_string.argtypes = [ctypes.c_int]
        so.repro_error_string.restype = ctypes.c_char_p
        _build._lib = so
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

    def time_ms(f, iters=20):
        f()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        pairs = []
        for _ in range(iters):
            scrub.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            f()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    def same(got, want):
        return all(torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                               w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
                   for g, w in zip(got, want))

    fields = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")
    has_pair = hasattr(kq, "quantize_kv_pair")
    result, bad = {}, 0
    for name, (b, h, prompt, d) in SHAPES:
        k = randn(b, prompt, h, d).transpose(1, 2)  # the model's strided views
        v = randn(b, prompt, h, d).transpose(1, 2)
        n_full = prompt // BN
        n = n_full * BN
        cache = qcache.init_cache(b, h, d, prompt + BN, device=dev)
        want = [*kq.quantize_kv(k[:, :, :n], BITS, "channel", block_n=BN, impl="torch"),
                *kq.quantize_kv(v[:, :, :n], BITS, "tensor", block_n=BN, impl="torch")]
        heads = [getattr(cache, f)[:, :, :n_full] for f in fields]

        def parent_fill():
            for dst, x, gran in ((heads[:3], k, "channel"), (heads[3:], v, "tensor")):
                for to, o in zip(dst, kq.quantize_kv(x[:, :, :n], BITS, gran, block_n=BN,
                                                     impl="cuda")):
                    to.copy_(o)

        calls = {
            "K": lambda: kq.quantize_kv(k[:, :, :n], BITS, "channel", block_n=BN, impl="cuda"),
            "V": lambda: kq.quantize_kv(v[:, :, :n], BITS, "tensor", block_n=BN, impl="cuda"),
            "fill": lambda: qcache._quantize_full_region(cache, k, v, n_full, "cuda"),
        }
        if has_pair:
            calls["pair"] = lambda: kq.quantize_kv_pair(
                k[:, :, :n], v[:, :, :n], BITS, "channel", block_n=BN, out_k=heads[:3],
                out_v=heads[3:], impl="cuda")
            calls["two launches"] = lambda: (
                kq.quantize_kv(k[:, :, :n], BITS, "channel", block_n=BN, impl="cuda",
                               out=heads[:3]),
                kq.quantize_kv(v[:, :, :n], BITS, "tensor", block_n=BN, impl="cuda",
                               out=heads[3:]))
            calls["parent's fill"] = parent_fill
        for what, f in calls.items():
            for x in heads:
                x.zero_()
            out = f()
            alone = {"K": want[:3], "V": want[3:]}
            ok = same(out, alone[what]) if what in alone else same(heads, want)
            if not ok:
                bad += 1
                print(f"  PARITY FAILED {tree.name}{' ' + lib if lib else ''} {name} {what}",
                      file=sys.stderr)
            result[f"{name} {what}"] = time_ms(f) * 1e3
    result["launch floor"] = time_ms(lambda: torch.cuda._sleep(0)) * 1e3
    print(json.dumps({"us": result, "parity_failures": bad}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="NAME=DIR: the root of another version of the tree to time")
    parser.add_argument("--ablate", action="store_true",
                        help="also time this tree's source with each of ABLATIONS applied")
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=FILE: another kv_quant.cu with the same C interface")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--lib", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(Path(args.worker), args.lib)
    import torch

    if not torch.cuda.is_available():
        print("kv_quant_variants: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    versions = {"this": (ROOT, None)}
    for spec in args.tree:
        name, _, path = spec.partition("=")
        versions[name] = (Path(path).resolve(), None)
    builds = {name: subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.build()", str(path / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, _) in versions.items()}
    sources = [spec.partition("=")[::2] for spec in args.variant]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    if args.ablate:
        text = (_build.CSRC / "kv_quant.cu").read_text()
        for name, (what, old, new) in ABLATIONS.items():
            if text.count(old) != 1:
                print(f"ablation {name}: the text to replace is not in the source once",
                      file=sys.stderr)
                return 1
            (out / f"kq_{name}.cu").write_text(text.replace(old, new))
            sources.append((name, str(out / f"kq_{name}.cu")))
            print(f"  ablation {name}: {what}", flush=True)
    for name, src in sources:
        so = out / f"libkq_{name}.so"
        builds[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o", str(so),
             src, str(_build.CSRC / "common.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        versions[name] = (ROOT, str(so))
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"  {name}: build failed\n{log[-3000:]}", flush=True)
            return 1
    times = {name: {} for name in versions}
    failed = 0
    order = list(versions)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            path, lib = versions[name]
            proc = subprocess.run([sys.executable, __file__, "--worker", str(path)]
                                  + (["--lib", lib] if lib else []), capture_output=True, text=True)
            sys.stderr.write(proc.stderr[-4000:])
            if proc.returncode:
                failed += 1
                print(f"  {name}: worker failed ({proc.returncode})", flush=True)
                continue
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            if res["parity_failures"] and lib is None:
                failed += 1
            for what, us in res["us"].items():
                times[name].setdefault(what, []).append(us)
            print(f"  round {rnd + 1} {name}: " + ", ".join(
                f"{w} {us:.1f}" for w, us in res["us"].items())
                + f"; parity failures {res['parity_failures']}", flush=True)
    rows = []
    for sname, (b, h, prompt, d) in SHAPES:
        n = prompt // BN * BN
        k_b, v_b = nbytes(b, h, n, d, True), nbytes(b, h, n, d, False)
        bounds = {"K": k_b, "V": v_b}
        for name, res in times.items():
            for what, us in res.items():
                if not what.startswith(sname):
                    continue
                part = what[len(sname) + 1:]
                bound_us = bounds.get(part, k_b + v_b) / HBM_BYTES_PER_S * 1e6
                mean = sum(us) / len(us)
                rows.append(dict(shape=sname, call=part, version=name, us=us, bound_us=bound_us,
                                 share_of_bound=bound_us / mean))
                print(f"  {sname} {part} {name}: {' / '.join(f'{x:.1f}' for x in us)} us, "
                      f"{bound_us / mean:.1%} of the {bound_us:.2f} us bound", flush=True)
    for name, res in times.items():
        print(f"  {name}: launch floor {' / '.join(f'{x:.1f}' for x in res['launch floor'])} us")
    print(json.dumps({"kv_quant_variants": rows}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
