"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds. The
kernel wrappers count their launches in ``launch_counts``.

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
_ROLLOUT = [
    _I, _P, _P, _I, _I, _F,  # device, x0, U, K, T, dt
    _P, _P, _P,              # dynamics params, cost params, cost map
    _P, _P, _P, _F, _F, _I,  # lr mean/sigma/coeff, gain, thresh, with_lr
    _I, _I, _F,              # epilogue, per-sample x0, lam_w
    _P, _P, _P, _P,          # costs, crash, carry, stream
]
_SOLVE = [
    _I, _I, _P, _P, _P, _P, _P, _P,  # device, noise kind, x0, mean, sigma, aux, lrc, cons
    _P, _P, _I, _I, _I,              # seed, injected normals, K, T, stride
    _F, _F, _F, _F,                  # pure thresh, dt, lr gain, lam_w
    _P, _P, _P,                      # dynamics params, cost params, cost map
    _P, _P, _P, _P, _P,              # costs, crash, U, carry, stream
]
_SAMPLE = [
    _I, _I, _I, _P, _P, _P, _P, _P, _P,  # device, kind, epilogue, x0, mean, sigma, aux, coeff, cons
    _P, _P, _I, _I, _I,                  # seed, injected normals, K, T, stride
    _F, _F, _F, _F, _F,                  # pure thresh, dt_smooth, dt, lr gain, lam_w
    _P, _P, _P,                          # dynamics params, cost params, cost map
    _P, _P, _P, _P, _P, _P,              # costs, crash, U, W, carry, stream
]
# The (dynamics, cost) pairs with kernel entries: each has its own source
# csrc/pair_<name>.cu and library, and the kernels named here (B1 "rollout":
# rollout_costs_<name>, B3 "solve": fused_solve_<name>, B4 "sample":
# fused_sample_rollout_<name>), so that nvcc builds the pairs in parallel.
# B1's per-sample-x0 entries ("rollout_x0": rollout_costs_x0_<name>) are in
# the one library of csrc/rollout_x0.cu.
PAIR_KERNELS = {
    "di_circle": ("rollout", "rollout_x0", "solve", "sample"),
    "ar_nn": ("rollout", "rollout_x0", "solve"),
    "bicycle_ar": ("rollout", "rollout_x0"),
    "cartpole": ("rollout", "solve", "sample"),
    "quadrotor_quadratic": ("rollout", "solve"),
    "quadrotor_map": ("rollout", "solve"),
    "dubins_quadratic": ("rollout", "solve"),
    "di_quadratic": ("rollout", "solve"),
}
_ENTRY_PREFIX = {"rollout": "rollout_costs_", "rollout_x0": "rollout_costs_x0_",
                 "solve": "fused_solve_", "sample": "fused_sample_rollout_"}


def pair_entry(pair: str, kind: str):
    """(library, C function) of kernel ``kind`` ("rollout", "rollout_x0",
    "solve" or "sample") for the pair ``pair``, or None where it has no
    entry."""
    if kind not in PAIR_KERNELS.get(pair, ()):
        return None
    lib = "rollout_x0" if kind == "rollout_x0" else f"pair_{pair}"
    return lib, _ENTRY_PREFIX[kind] + pair


SIGNATURES = {
    "flash_combine": {
        "kernel_block_size": [],
        # device, carry, nb, TC, lam, new_mean, scal, num, stream
        "flash_combine": [_I, _P, _I, _I, _F, _P, _P, _P, _P],
    },
    "tsallis_reduce": {
        "tsallis_reduce_block_size": [],
        "tsallis_reduce": [
            _I, _P, _P, _P, _I,  # device, U, costs, rho source, its length
            _I, _I, _I, _F, _F,  # K valid, K rows, TC, gamma, 1 / (r - 1)
            _P, _P, _P,          # rows, rho, stream
        ],
    },
    "rmppi_rollout": {
        "rmppi_rollout_di_circle": [
            _I, _P, _P, _P, _I, _I, _F,  # device, x0_nom, x0_real, U, K, T, dt
            _P, _P, _P, _P, _P, _F,      # cost params, constraints, gains, sigma, coeff, fb gain
            _P, _P, _P, _P, _P, _P,      # s_nom, j_real, s_fb, crash, U_real, stream
        ],
    },
    "riccati": {
        "riccati_max_alphas": [],
        "riccati_backward_s4c2": [
            _I, _P, _P, _P, _P, _P, _P, _P, _P,  # device, As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T
            _I, _F, _F, _P, _P, _P,              # T, dt, reg, Ks, ks, stream
        ],
        "riccati_ladder_di": [
            _I, _P, _P, _P, _P, _P, _P, _P, _P,  # device, As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T
            _P, _P, _P, _P, _P, _P, _P, _P, _P,  # xs, us, goal_x, goal_u, Q, R, Q_f, ulim, alphas
            _I, _I, _F, _F,                      # n_alpha, T, dt, reg
            _P, _P, _P, _P, _P, _P,              # Ks, ks, costs, xs_new, us_new, stream
        ],
    },
}
_KIND_SIGNATURE = {"rollout": _ROLLOUT, "rollout_x0": _ROLLOUT, "solve": _SOLVE,
                   "sample": _SAMPLE}
for _pair, _kinds in PAIR_KERNELS.items():
    for _kind in _kinds:
        _lib, _fn = pair_entry(_pair, _kind)
        SIGNATURES.setdefault(_lib, {})[_fn] = _KIND_SIGNATURE[_kind]

# launches of each CUDA kernel since the last reset_launch_counts(); each
# wrapper adds one where it launches its kernel, and one to entry_counts
# under the C function of a pair's entry (e.g. "fused_solve_cartpole")
entry_counts = {}
launch_counts = {
    "rollout_costs_kernel": 0,
    "flash_combine_kernel": 0,
    "tsallis_reduce_kernel": 0,
    "rmppi_rollout_kernel": 0,
    "riccati_backward_kernel": 0,
    "riccati_ladder_kernel": 0,
    "fused_solve_kernel": 0,
    "fused_sample_rollout_kernel": 0,
}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0
    entry_counts.clear()


def count_launch(kernel: str, entry: str | None = None):
    """One launch of ``kernel`` (through the pair entry ``entry``)."""
    launch_counts[kernel] += 1
    if entry is not None:
        entry_counts[entry] = entry_counts.get(entry, 0) + 1


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
