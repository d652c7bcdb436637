#!/usr/bin/env python3
"""Time the port's flash-prefill kernel (K6, ``src/repro_torch/csrc/flash_prefill.cu``)
against PyTorch's ``scaled_dot_product_attention``, all in one process on
one card: the kernel as the library builds it, launched with the wrapper's
choice of CTAs (``launch_ctas``) and with the other choice (one CTA per SM
or one per work tile), and other versions of its source.

    python3 scripts/flash_prefill_variants.py
    python3 scripts/flash_prefill_variants.py --variant parent=old/flash_prefill.cu

Each other version is compiled by ``nvcc`` with the library's flags,
against ``csrc/``, into a library of its own under ``csrc/build/variants/``.
Every library is checked against the plain version on a few small cases
before it is timed.  Times are device times of one call (CUDA events, L2
scrubbed before each call, calls queued behind a spin kernel), taken in
turns: every variant and SDPA at one shape, then again in reverse order;
both rounds are printed.  The bound is the causal half's operations at 989
TFLOP/s (bf16, H100 SXM).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

BF16_OPS_PER_S = 989e12
SHAPES = ((4, 32, 8, 2048, 128), (4, 16, 16, 1200, 256), (1, 32, 8, 8192, 128))
PARITY = ((1, 2, 1, 129, 64, True), (2, 24, 2, 300, 128, True), (1, 8, 2, 1900, 128, False),
          (2, 8, 2, 2100, 256, True), (1, 4, 4, 65, 32, True), (1, 2, 1, 48, 128, True),
          (1, 2, 2, 200, 256, False))


def build_variant(name: str, src: str):
    """Another version of flash_prefill.cu (say, the parent commit's), built
    with the library's flags against csrc/ into a library of its own."""
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
    fn_name, argtypes = _build._SIGNATURES["flash_prefill"]
    getattr(lib, fn_name).argtypes, getattr(lib, fn_name).restype = argtypes, ctypes.c_int
    lib.repro_error_string.argtypes, lib.repro_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def ptxas_lines(log: str) -> list[str]:
    """Registers, spills and wgmma serialization notes of each K6 instance."""
    keep, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '_Z\d+flash_prefill_kernelILi(\d+)E", line)
        if m:
            info = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
            keep.append(f"d={m.group(1)}: {info}")
        elif "C7512" in line or "C7510" in line:
            keep.append(re.sub(r" for the function.*", "", line.split(":", 1)[-1].strip()))
    return keep


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=FILE: another flash_prefill.cu to time beside this one")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_prefill_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_prefill import ops as fp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    variants = {"built": _build.build()}
    for line in ptxas_lines(_build.ptxas_report()):
        print(f"  ptxas built: {line}")
    jobs = {}
    for spec in args.variant:
        name, _, src = spec.partition("=")
        jobs[name] = build_variant(name, src)
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"variant {name} failed to build:\n{log}", file=sys.stderr)
            return 1
        for line in ptxas_lines(log):
            print(f"  ptxas {name}: {line}")
        variants[name] = bind(so)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, hq, hkv, s, d):
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        return q, k, (v + 2.0 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)

    chosen = fp.launch_ctas

    def run(lib, *a, ctas=chosen, **kw):
        _build._lib = lib  # build() hands this library to every launch
        fp.launch_ctas = ctas
        try:
            return fp.flash_prefill_attention(*a, **kw)
        finally:
            fp.launch_ctas = chosen

    def other_ctas(b, hq, s, d, sms):  # the choice launch_ctas does not make
        n = fp.work_tiles(b, hq, s)
        return min(n, sms) if chosen(b, hq, s, d, sms) == n else n

    bad = 0
    for case in PARITY:
        b, hq, hkv, s, d, causal = case
        q, k, v = inputs(b, hq, hkv, s, d)
        kw = dict(causal=causal, layout="bshd", return_lse=True)
        out_r, lse_r = fp.flash_prefill_attention(q, k, v, impl="torch", **kw)
        for name, lib, ctas in [*((n, lib, chosen) for n, lib in variants.items()),
                                ("built, other CTAs", variants["built"], other_ctas)]:
            out, lse = run(lib, q, k, v, impl="cuda", ctas=ctas, **kw)
            ok = (torch.allclose(out.float(), out_r.float(), rtol=3e-2, atol=3e-2)
                  and torch.allclose(lse, lse_r, rtol=1e-3, atol=1e-3))
            bad += not ok
            if not ok:
                print(f"  PARITY FAILED {name} {case}")
    n_cases = len(PARITY) * (len(variants) + 1)
    print(f"  parity: {n_cases - bad} of {n_cases} cases within out 3e-2 / lse 1e-3", flush=True)

    scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

    def time_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        pairs = []
        for _ in range(iters):
            scrub.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    results = []
    for b, hq, hkv, s, d in SHAPES:
        q, k, v = inputs(b, hq, hkv, s, d)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        ops = 4 * b * hq * d * (s * (s + 1) // 2)
        fns = {name: (lambda lib=lib: run(lib, q, k, v, layout="bshd", impl="cuda"))
               for name, lib in variants.items()}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        other = "one CTA per work tile" if other_ctas(b, hq, s, d, sms) > sms else "one CTA per SM"
        fns[f"built, {other}"] = lambda: run(variants["built"], q, k, v, layout="bshd",
                                             impl="cuda", ctas=other_ctas)
        fns["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True)
        order = list(fns)
        times = {name: [] for name in order}
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(time_ms(fns[name]))
        bound_us = ops / BF16_OPS_PER_S * 1e6
        for name in order:
            us = [t * 1e3 for t in times[name]]
            mean = sum(us) / len(us)
            row = dict(shape=dict(B=b, Hq=hq, Hkv=hkv, S=s, d=d), variant=name, us=us,
                       tflops=ops / mean / 1e6, bound_us=bound_us, share_of_bound=bound_us / mean,
                       vs_sdpa=mean / (sum(times["sdpa"]) / len(times["sdpa"]) * 1e3))
            results.append(row)
            print(f"  B={b} Hq={hq} Hkv={hkv} S={s} d={d} {name}: "
                  f"{' / '.join(f'{x:.1f}' for x in us)} us, {row['tflops']:.0f} TFLOP/s, "
                  f"{row['share_of_bound']:.1%} of the {bound_us:.2f} us bound, "
                  f"{row['vs_sdpa']:.2f}x sdpa", flush=True)
        del q, k, v, qh, kh, vh
    print(json.dumps({"flash_prefill_variants": results}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
