#!/usr/bin/env python3
"""Planted faults in the residual-flush kernel (K2 ``residual_flush`` and K5
``paged_residual_flush``, both modes, ``src/repro_torch/csrc/residual_flush.cu``):
which GPU tests catch each.

    python3 scripts/flush_faults.py

Each fault is planted in a copy of ``src/`` in a temporary directory (the
tree itself is never edited); the copies are built at once, then
``tests/test_torch_gpu.py`` runs against each (the flush kernel's, the smoke
models' and the small engine's tests) and the failures are counted by test.
A fault that no test catches makes the script exit non-zero.  Needs a CUDA
card; about 4 minutes on an H100.
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
BODY = "repro_torch/csrc/residual_flush.cu"
# name -> (what it breaks, text of the kernel, its replacement)
FAULTS = {
    "newest_from_residual": (
        "a flushing CTA stages the newest token from the residual row being written",
        "      u[p] = APPEND && step && tok == at  // the new token, not its residual row",
        "      u[p] = false  // the new token, not its residual row"),
    "counter_kept": ("the last CTA of a row leaves the arrival counter as it is",
                     "      a.arrive[b] = 0;\n", ""),
    "group_rows": ("a group's word-row range one row short",
                   "i1 = min(npr, i0 + per), nr", "i1 = min(npr, i0 + per - 1), nr"),
    "mask_ignored": ("the mask ignored: every row appends",
                     "      step = a.mask ? (a.mask[b] != 0) : 1;", "      step = 1;"),
}
TESTS = "flush or append or smoke_model or small_engine"
BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from repro_torch.kernels import _build; _build.build()")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flush_faults: no CUDA device", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="flush_faults_"))
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
            print(f"flush_faults: no test caught {missed}", file=sys.stderr)
        return 1 if missed else 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
