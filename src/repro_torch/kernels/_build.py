"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

On first CUDA use, one ``nvcc`` process per source compiles it for
``sm_90a``, all started together; one more links the objects into a shared
library with a plain C interface, and ``ctypes`` binds it.  The library is
named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged tree is reused.  There is deliberately no
``--use_fast_math``: the quantize kernels must produce the same codes as the
plain PyTorch version, bit for bit.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises when that is not 0 and otherwise counts the launch in
:data:`launches`, the count a run reads to show which kernels it went through.
"""
from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last clear(); only :func:`launch` adds
launches: collections.Counter = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# kernel name -> C entry point and its signature (see csrc/*.cu)
_SIGNATURES = {
    # K alone or K and V: the tensors, then a host array of their strides
    "kv_quant": ("kv_quant_launch", [_P] * 9 + [_I] * 9 + [_P]),
    # both modes of both caches: one entry point, counted as dense or paged
    "residual_flush": ("residual_flush_launch", [_P] * 17 + [_L] * 4 + [_I] * 15 + [_P]),
    "bitdecode": ("bitdecode_launch", [_P] * 13 + [_I] * 16 + [_F, _P]),
    "bitdecode_merge": ("bitdecode_merge_launch", [_P] * 4 + [_I] * 3 + [_L] * 2 + [_P]),
    "paged_residual_flush": ("residual_flush_launch", [_P] * 17 + [_L] * 4 + [_I] * 15 + [_P]),
    "paged_bitdecode": ("paged_bitdecode_launch", [_P] * 14 + [_I] * 18 + [_F, _P]),
    "flash_prefill": ("flash_prefill_launch", [_P] * 5 + [_I] * 6 + [_L] * 12
                      + [_I, _F, _I, _P]),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> ctypes.CDLL:
    """Compile the library if it is missing, and bind its entry points."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile_and_link(so)
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in _SIGNATURES.values():
        fn = getattr(lib, fn_name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.flash_prefill_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_prefill_smem_bytes.restype = ctypes.c_int
    lib.bitdecode_ctas_per_sm.argtypes = [ctypes.c_int] * 6
    lib.bitdecode_ctas_per_sm.restype = ctypes.c_int
    _lib = lib
    build_seconds = time.perf_counter() - t0
    return lib


def _compile_and_link(so: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then the link."""
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = any(proc.returncode for proc in procs)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        failed = link.returncode != 0
    for obj in objs:
        obj.unlink(missing_ok=True)
    (BUILD_DIR / "nvcc.log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed:\n{''.join(logs)}")
    os.replace(tmp, so)


def sass_counts_many(specs, library: str | None = None) -> list | None:
    """For each ``(names, fn_filter)`` in ``specs``: per kernel function of
    the built library (or ``library``) whose mangled name holds
    ``fn_filter``, how many of its SASS instructions start with each of
    ``names``, all from one ``cuobjdump -sass``; None where the toolkit has
    no cuobjdump."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", library or build()._name], capture_output=True,
                          text=True, check=True).stdout
    return [count_sass(sass, names, fn_filter) for names, fn_filter in specs]


def count_sass(sass: str, names: tuple[str, ...], fn_filter: str) -> dict:
    """The counting of :func:`sass_counts_many` on ``cuobjdump -sass`` text."""
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            fn = fn if fn_filter in fn else None
            if fn:
                counts[fn] = dict.fromkeys(names, 0)
        elif fn and "*/" in line:
            words = line.split("*/", 1)[1].split()  # [@predicate] opcode operands
            op = words[1] if words and words[0].startswith("@") else words[0] if words else ""
            for name in names:
                counts[fn][name] += op.startswith(name)
    return counts


def ptxas_report() -> str:
    """nvcc's ``-Xptxas -v`` output (registers, shared memory, spills) of
    the last build."""
    log = BUILD_DIR / "nvcc.log"
    return log.read_text() if log.exists() else ""


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point; raise if the launch failed."""
    lib = build()
    err = getattr(lib, _SIGNATURES[name][0])(*args)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {err})")
    launches[name] += 1


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def resolve_impl(impl: str, *tensors) -> str:
    """'auto' -> 'cuda' when any tensor is on the card, else 'torch'.
    'cuda' needs every tensor on the card and raises otherwise, so tensors
    split between the CPU and the card raise under 'auto' too: there is no
    silent fallback to the plain version."""
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}; expected 'auto', 'cuda' or 'torch'")
    devices = {t.device.type for t in tensors if t is not None}
    if impl == "auto":
        impl = "cuda" if "cuda" in devices else "torch"
    if impl == "cuda" and devices != {"cuda"}:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got tensors on {sorted(devices)}; "
                         "use impl='torch' for the plain version")
    return impl
