"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds.

The libraries go to ``build/torch_kernels/<hash>/`` at the root of the
checkout, keyed by a hash of every source file and of the compiler flags,
and guarded by a file lock so that concurrent processes build once. The
build happens at first use, never at import: the CPU tests import every
module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# No --use_fast_math: expf/logf/sqrtf keep their accurate forms. --fmad=false
# keeps each multiply and add rounded on its own, as PyTorch's eager
# operations are, so the kernels reproduce their plain versions exactly.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The C functions of each library and their ctypes signatures. Pointers and
# the stream are c_void_p: a plain int would be cut to 32 bits.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_rollout": {
        "fused_rollout_block_size": [],
        "rollout_costs_di_circle": [
            _I, _P, _P, _I, _I, _F, _P,  # device, x0, U, K, T, dt, cost_params
            _P, _P, _P, _F, _F, _I,      # lr mean/sigma/coeff, gain, thresh, with_lr
            _I, _F, _P, _P, _P, _P,      # epilogue, lam_w, costs, crash, carry, stream
        ],
        "flash_combine": [_I, _P, _I, _I, _F, _P, _P, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on a machine with "
        "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Build every ``csrc/*.cu`` into its own library, one ``nvcc`` process
    per source, all started together. Returns ``{name: {"path", "log"}}``;
    a library already built from the same sources is reused (its log is
    then the one saved beside it)."""
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            procs = {}
            for src in sources:
                lib = out_dir / f"lib{src.stem}.so"
                if lib.exists():
                    continue
                tmp = out_dir / f"lib{src.stem}.so.tmp{os.getpid()}"
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(src)]
                procs[src.stem] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, lib)
            failed = []
            for name, (proc, tmp, lib) in procs.items():
                log, _ = proc.communicate()
                (out_dir / f"{name}.log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, lib)
            if failed:
                raise RuntimeError("kernel build failed: " + "\n".join(failed))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    result = {}
    for src in sources:
        log_path = out_dir / f"{src.stem}.log"
        result[src.stem] = {
            "path": str(out_dir / f"lib{src.stem}.so"),
            "log": log_path.read_text() if log_path.exists() else "",
        }
    return result


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with the
    ``argtypes`` and ``restype`` of every function declared."""
    lib = ctypes.CDLL(build_all()[name]["path"])
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
