#!/usr/bin/env python3
"""Planted faults in the decode kernels' shared body (K3 ``bitdecode`` and
K4 ``paged_bitdecode``, ``src/repro_torch/csrc/bitdecode_body.cuh``): which
GPU tests catch each.

    python3 scripts/bitdecode_faults.py

Each fault is planted in a copy of ``src/`` in a temporary directory (the
tree itself is never edited); the copies are built at once, then
``tests/test_torch_gpu.py`` runs against each (the decode kernels', the smoke
models' and the small engine's tests) and the failures are counted by test.
A fault that no test catches makes the script exit non-zero.  Needs a CUDA
card; about 2 minutes on an H100.
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
BODY = "repro_torch/csrc/bitdecode_body.cuh"
# name -> (what it breaks, text of the body, its replacement)
FAULTS = {
    "no_alpha": ("no rescale of the accumulator by alpha",
                 "        o[t][nt][e] *= alpha;\n        o[t][nt][2 + e] *= alpha;\n", ""),
    "permutation": ("PV reads word rows 2t + 1 and 2t where QK^T put tokens 2t and 2t + 1",
                    "  const int r0 = (2 * tig) % W, r1 = (2 * tig + 1) % W;",
                    "  const int r0 = (2 * tig + 1) % W, r1 = (2 * tig) % W;"),
    "mask": ("the residual mask off by one", "(c < 2 && gam < valid)", "(c < 2 && gam <= valid)"),
    "empty_split": ("an empty split's lse 0, not ~ -1e37 (not weighted out)",
                    "    if (tid < a.g) a.lse[base + tid] = MASK_VALUE + logf(1e-30f);",
                    "    if (tid < a.g) a.lse[base + tid] = 0.f;"),
}
TESTS = "bitdecode or decode_ or smoke_model or small_engine"
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.build()")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bitdecode_faults: no CUDA device", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="bitdecode_faults_"))
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
            print(f"bitdecode_faults: no test caught {missed}", file=sys.stderr)
        return 1 if missed else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
