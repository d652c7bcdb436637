#!/usr/bin/env python3
"""Planted faults in the prefill quantize kernel (K1 ``kv_quant``,
``src/repro_torch/csrc/kv_quant.cu``): which GPU tests catch each.

    python3 scripts/kv_quant_faults.py

Each fault is planted in a copy of ``src/`` in a temporary directory (the
tree itself is never edited); the copies are built at once, then
``tests/test_torch_gpu.py`` runs against each (K1's tests, the appended
block against K1's, the smoke models' and the small engine's) and the
failures are counted by test.  A fault that no test catches makes the
script exit non-zero.  Needs a CUDA card; about 4 minutes on an H100.
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BODY = "repro_torch/csrc/kv_quant.cu"
# name -> (what it breaks, text of the kernel, its replacement)
FAULTS = {
    "stats_127_tokens": (
        "per-channel statistics over the first block_n - 1 tokens of a block",
        "        if (CH) {\n          mn[e] = fminf(mn[e], f[e]);",
        "        if (CH && j < n.rows - 1) {\n          mn[e] = fminf(mn[e], f[e]);"),
    "v_params_per_channel": (
        "V's params per channel when K's are",
        "setup_tensor(T, ds[t], t == 0 && k_channel,", "setup_tensor(T, ds[t], k_channel,"),
    "out_stride_ignored": (
        "the words' head stride taken as a fresh output's, not the view's",
        "    T.w_sh = st[4];", "    T.w_sh = (long long)nb * npr * ds[t];"),
    "kv_swapped_in_one_group": (
        "K and V read from each other's tensor for (b, h) = (0, 1) in a pair launch",
        "  const bf16* x = T.x + n.b * T.x_sb",
        "  const bf16* x = a.t[n.t ^ (a.units > a.t[0].units && n.b == 0 && n.h == 1)].x"
        " + n.b * T.x_sb"),
}
TESTS = "kv_quant or prefill_layer or appended or smoke_model or small_engine"
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.build()")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kv_quant_faults: no CUDA device", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="kv_quant_faults_"))
    try:
        trees = {}
        for name, (_, old, new) in FAULTS.items():
            src = work / name / "src"
            shutil.copytree(ROOT / "src", src,
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            body = src / BODY
            text = body.read_text()
            if text.count(old) != 1:
                print(f"{name}: the text to replace is not in the body once", file=sys.stderr)
                return 1
            body.write_text(text.replace(old, new))
            trees[name] = src
        builds = {name: subprocess.Popen([sys.executable, "-c", BUILD, str(src)],
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True) for name, src in trees.items()}
        for name, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode:
                print(f"{name}: build failed\n{log[-3000:]}", file=sys.stderr)
                return 1
        missed = []
        for name, src in trees.items():
            run = subprocess.run(
                [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-k", TESTS,
                 "-p", "no:cacheprovider", str(ROOT / "tests" / "test_torch_gpu.py")],
                capture_output=True, text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(src)})
            failed = collections.Counter(
                re.sub(r"\[.*", "", line.split()[1]).split("::")[-1]
                for line in run.stdout.splitlines() if line.startswith("FAILED"))
            summary = run.stdout.strip().splitlines()[-1] if run.stdout.strip() else "no output"
            print(f"{name} ({FAULTS[name][0]}): {summary}", flush=True)
            for test, n in sorted(failed.items()):
                print(f"    {n} x {test}")
            if not failed:
                missed.append(name)
        if missed:
            print(f"kv_quant_faults: no test caught {missed}", file=sys.stderr)
        return 1 if missed else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
