#!/usr/bin/env python3
"""Where a K3 ``bitdecode`` call's time goes inside the kernel, CTA by CTA:
each CTA's start, the wait for its first unit's words, its loop over units,
its combine and epilogue, read from the card's %globaltimer.

    python3 scripts/bitdecode_trace.py

The stamps are inserted into a copy of ``src/`` in a temporary directory
(the tree itself is never edited, and the kernel there carries no stamp),
built, and one call is traced at each decode shape of llama3-8b, gemma-7b
and starcoder2-3b, with ``num_splits`` "auto", 1 and 4, L2 scrubbed before
the call.  Printed per call: the quantiles (p0, p50, p90, max, in us) of
each phase over the CTAs that had units, and the CTAs an SM held at most.
Needs a CUDA card; about 1.5 minutes on an H100.
"""
from __future__ import annotations

import ctypes
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BODY = "repro_torch/csrc/bitdecode_body.cuh"
MAX_CTAS = 8192
# (text of the body, the text with a stamp added): stamp 0 at entry (and the
# SM in 5), 1 when warp 0's first unit has landed, 2 after its loop, 3 after
# the CTA's barrier, 4 after the output's stores
STAMPS = [
    ("#define MASK_VALUE (-1e37f)",
     "#define MASK_VALUE (-1e37f)\n"
     f"static __device__ unsigned long long bd_trace[{MAX_CTAS} * 6];\n"
     "__device__ __forceinline__ unsigned long long bd_now() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}"),
    ('  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n',
     '  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");\n'
     "  const int trace_i = (blockIdx.y * gridDim.x + blockIdx.x) * 6;\n"
     f"  const bool tracer = threadIdx.x == 0 && trace_i < {MAX_CTAS} * 6;\n"
     "  if (tracer) {\n    unsigned int smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    bd_trace[trace_i] = bd_now();\n    bd_trace[trace_i + 5] = smid;\n"
     "    for (int k = 1; k < 5; ++k) bd_trace[trace_i + k] = 0;\n  }\n"),
    ("    cp_async_wait<1>();\n    __syncwarp();\n",
     "    cp_async_wait<1>();\n    __syncwarp();\n"
     "    if (tracer && u == lo) bd_trace[trace_i + 1] = bd_now();\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every warp is done with its ring\n",
     "  cp_async_wait<0>();\n  if (tracer) bd_trace[trace_i + 2] = bd_now();\n"
     "  __syncthreads();  // every warp is done with its ring\n"
     "  if (tracer) bd_trace[trace_i + 3] = bd_now();\n"),
    ("    a.out[base * DV + i] = acc / lt_s[gi];\n  }\n}",
     "    a.out[base * DV + i] = acc / lt_s[gi];\n  }\n"
     "  if (tracer) bd_trace[trace_i + 4] = bd_now();\n}"),
]
READER = """
extern "C" int bd_trace_read(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, bd_trace, sizeof(unsigned long long) * 6 * n);
}
"""
# name, (B, H_kv, g, d, nb), pack_blocks, res_len
SHAPES = (("llama3-8b", (4, 8, 4, 128, 18), [14, 15, 16, 16], [108, 80, 2, 52]),
          ("gemma-7b", (4, 16, 1, 256, 11), [8, 8, 9, 9], [104, 56, 126, 48]),
          ("starcoder2-3b", (4, 2, 12, 128, 11), [8, 8, 9, 9], [104, 56, 126, 48]))


def instrumented_copy(work: Path) -> Path:
    src = work / "src"
    shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns("build", "__pycache__"))
    body = src / BODY
    text = body.read_text()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise SystemExit(f"bitdecode_trace: {old.strip()[:60]!r} is not in the body once")
        text = text.replace(old, new)
    body.write_text(text)
    dense = src / "repro_torch/csrc/bitdecode.cu"
    dense.write_text(dense.read_text() + READER)
    return src


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bitdecode_trace: no CUDA device", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="bitdecode_trace_"))
    try:
        sys.path.insert(0, str(instrumented_copy(work)))
        from repro_torch.kernels import _build
        from repro_torch.kernels.bitdecode import ops as bd
        from repro_torch.kernels.kv_quant import ops as kq

        lib = _build.build()
        lib.bd_trace_read.argtypes, lib.bd_trace_read.restype = [ctypes.c_void_p, ctypes.c_int], \
            ctypes.c_int
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        scrub = torch.empty(64 * 2**20, dtype=torch.int8, device=dev)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        def q(x):
            return " ".join(f"{v:.2f}" for v in np.percentile(x, [0, 50, 90, 100])) if len(x) else "-"

        for name, (b, h, g, d, nb), pb, rl in SHAPES:
            cache = [*kq.quantize_kv(randn(b, h, nb * 128, d), 4, "channel", block_n=128),
                     *kq.quantize_kv(randn(b, h, nb * 128, d), 4, "tensor", block_n=128)]
            args = [randn(b, h, g, d), *cache, randn(b, h, 128, d), randn(b, h, 128, d),
                    torch.tensor(pb, dtype=torch.int32, device=dev),
                    torch.tensor(rl, dtype=torch.int32, device=dev)]
            units = bd.work_units(nb, 128, 4, 128)
            for ns in ("auto", 1, 4):
                splits = bd.resolve_num_splits(ns, b, h, units, dev, g=g, d=d)
                call = lambda: bd.bitdecode_attention(*args, bits=4, block_n=128,  # noqa: E731
                                                      num_splits=ns)
                call()
                scrub.zero_()
                torch.cuda.synchronize()
                call()
                torch.cuda.synchronize()
                n = b * h * splits
                buf = np.zeros(n * 6, dtype=np.uint64)
                if lib.bd_trace_read(buf.ctypes.data, min(n, MAX_CTAS)):
                    raise SystemExit("bitdecode_trace: reading the stamps failed")
                t = buf.reshape(n, 6).astype(np.int64)
                busy = t[:, 4] > 0
                t0 = t[:, 0].min()
                phases = {"start": (t[busy, 0] - t0), "first unit": t[busy, 1] - t[busy, 0],
                          "loop": t[busy, 2] - t[busy, 1], "barrier": t[busy, 3] - t[busy, 2],
                          "epilogue": t[busy, 4] - t[busy, 3], "end": t[busy, 4] - t0}
                per_sm = np.bincount(t[:, 5], minlength=1)
                print(f"{name} num_splits={ns} (->{splits}): {n} CTAs, {int(busy.sum())} with "
                      f"units, at most {per_sm.max()} on an SM; p0 p50 p90 max us: "
                      + "; ".join(f"{k} {q(v / 1e3)}" for k, v in phases.items()), flush=True)
        return 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
