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
    _P, _P, _P, _P,          # dynamics params, cost params, cost map, dynamics map
    _P, _P, _P, _F, _F, _I,  # lr mean/sigma/coeff, gain, thresh, with_lr
    _I, _I, _F,              # epilogue, per-sample x0, lam_w
    _P, _P, _P, _P,          # costs, crash, carry, stream
]
_SOLVE = [
    _I, _I, _P, _P, _P, _P, _P, _P,  # device, noise kind, x0, mean, sigma, aux, lrc, cons
    _P, _P, _I, _I, _I,              # seed, injected normals, K, T, stride
    _F, _F, _F, _F,                  # pure thresh, dt, lr gain, lam_w
    _P, _P, _P, _P,                  # dynamics params, cost params, cost map, dynamics map
    _P, _P, _P, _P, _P,              # costs, crash, U, carry, stream
]
_SAMPLE = [
    _I, _I, _I, _P, _P, _P, _P, _P, _P,  # device, kind, epilogue, x0, mean, sigma, aux, coeff, cons
    _P, _P, _I, _I, _I,                  # seed, injected normals, K, T, stride
    _F, _F, _F, _F, _F,                  # pure thresh, dt_smooth, dt, lr gain, lam_w
    _P, _P, _P, _P,                      # dynamics params, cost params, cost map, dynamics map
    _P, _P, _P, _P, _P, _P,              # costs, crash, U, W, carry, stream
]
# the split form (csrc/split_kernels.cuh): B1's and B3's dynamics passes and
# the cost pass
_SPLIT_DYNAMICS = [
    _I, _P, _P, _I, _I, _F,  # device, x0, U, K, T, dt
    _P, _P, _P, _P,          # dynamics params, cost params, cost map, dynamics map
    _P, _P,                  # Y, stream
]
_SPLIT_SOLVE_DYNAMICS = [
    _I, _I, _P, _P, _P, _P, _P, _P,  # device, noise kind, x0, mean, sigma, aux, lrc, cons
    _P, _P, _I, _I, _I,              # seed, injected normals, K, T, stride
    _F, _F,                          # pure thresh, dt
    _P, _P, _P, _P,                  # dynamics params, cost params, cost map, dynamics map
    _P, _P, _P, _P,                  # U, Y, LR sums, stream
]
_SPLIT_COST = [
    _I, _P, _P, _I, _I, _P, _P,  # device, Y, U, K, T, cost params, cost map
    _P, _P, _P, _F, _F, _I,      # lr mean/sigma/coeff, gain, thresh, with_lr
    _P, _F,                      # LR sums, their gain
    _I, _F, _P, _P, _P,          # epilogue, lam_w, costs, crash, out
    _I, _P,                      # form, stream
]
_RMPPI = [
    _I, _P, _P, _P, _I, _I, _F,  # device, x0_nom, x0_real, U, K, T, dt
    _P, _P, _P, _P,              # dynamics params, cost params, cost map, dynamics map
    _P, _P, _P, _P, _F,          # constraints, gains, sigma, coeff, fb gain
    _P, _P, _P, _P, _P, _P,      # s_nom, j_real, s_fb, crash, U_real, stream
]
_BACKWARD = [
    _I, _P, _P, _P, _P, _P, _P, _P, _P,  # device, As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T
    _I, _F, _F, _P, _P, _P,              # T, dt, reg, Ks, ks, stream
]
_LADDER = [
    _I, _P, _P, _P, _P, _P, _P, _P, _P,  # device, As, Bs, dLx, dLu, Qdt, Rdt, Vxx_T, Vx_T
    _P, _P, _P, _P, _P, _P, _P, _P, _P,  # xs, us, goal_x, goal_u, Q, R, Q_f, ulim, alphas
    _P, _I, _I, _F, _F,                  # dynamics params, n_alpha, T, dt, reg
    _P, _P, _P, _P, _P, _P,              # Ks, ks, costs, xs_new, us_new, stream
]
# The (dynamics, cost) pairs with kernel entries: each has its own source
# csrc/pair_<name>.cu and library, and the kernels named here (B1 "rollout":
# rollout_costs_<name>, B3 "solve": fused_solve_<name>, B4 "sample":
# fused_sample_rollout_<name>), so that nvcc builds the pairs in parallel.
# B1's per-sample-x0 entries ("rollout_x0": rollout_costs_x0_<name>) of the
# first pairs are in the one library of csrc/rollout_x0.cu, B8's ("rmppi":
# rmppi_rollout_<name>) in that of csrc/rmppi_rollout.cu; the split form's
# ("split_dynamics", "split_solve_dynamics", "split_cost":
# split_dynamics_<name>, ...; and "split_dynamics_x0":
# split_dynamics_x0_<name>, B1's dynamics pass from one x0 per sample) in the
# pair's csrc/split_<name>.cu (_KIND_LIBRARY). An entry whose network or LSTM
# would add most of a source's build has a source of its own, and so do the
# robust family's entries of the later pairs, one csrc/robust_<name>.cu a
# pair (_ENTRY_LIBRARY).
_SPLIT = ("split_dynamics", "split_solve_dynamics", "split_cost")
_ROBUST = ("rollout_x0", "rmppi", "split_dynamics_x0")
PAIR_KERNELS = {
    "di_circle": ("rollout", "rollout_x0", "solve", "sample", "rmppi", *_SPLIT,
                  "split_dynamics_x0"),
    "di_robust": ("rollout", "rollout_x0", "solve", "sample", "rmppi", *_SPLIT,
                  "split_dynamics_x0"),
    "ar_nn": ("rollout", "rollout_x0", "solve", "sample", "rmppi", *_SPLIT,
              "split_dynamics_x0"),
    "bicycle_ar": ("rollout", "rollout_x0", "solve", "sample", "rmppi", *_SPLIT,
                   "split_dynamics_x0"),
    "cartpole": ("rollout", "solve", "sample", *_SPLIT, *_ROBUST),
    "quadrotor_quadratic": ("rollout", "solve", "sample", *_SPLIT, *_ROBUST),
    "quadrotor_map": ("rollout", "solve", "sample", "rollout_x0", "rmppi"),
    "dubins_quadratic": ("rollout", "solve", "sample", *_SPLIT, *_ROBUST),
    "di_quadratic": ("rollout", "solve", "sample", *_SPLIT, *_ROBUST),
    # no B8: the JAX package refuses a recurrent model there
    # (pallas_rollout.py:302), and RMPPI's stage 2 runs the eager augmented
    # rollout
    "racer_steering_ar": ("rollout", "solve", "sample", *_SPLIT, "rollout_x0",
                          "split_dynamics_x0"),
    "racer_unc_ar": ("rollout", "solve", "sample", *_SPLIT, "rollout_x0",
                     "split_dynamics_x0"),
    # the rest of the racer family, and the bicycle on its elevation map:
    # B1, B3 and B4 (their robust and split entries are still to come)
    **{pair: ("rollout", "solve", "sample")
       for pair in ("racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                    "bicycle_elevation_ar", "racer_elev_susp_ar")},
}
_ENTRY_PREFIX = {"rollout": "rollout_costs_", "rollout_x0": "rollout_costs_x0_",
                 "solve": "fused_solve_", "sample": "fused_sample_rollout_",
                 "rmppi": "rmppi_rollout_", "split_dynamics": "split_dynamics_",
                 "split_solve_dynamics": "split_solve_dynamics_",
                 "split_cost": "split_cost_", "split_dynamics_x0": "split_dynamics_x0_"}
_KIND_LIBRARY = {"rollout_x0": "rollout_x0", "rmppi": "rmppi_rollout",
                 **{kind: "split_{pair}" for kind in (*_SPLIT, "split_dynamics_x0")}}
# the entries with a source of their own: B4 of the network and LSTM pairs
# (csrc/sample_<name>.cu), AutoRally's per-sample-x0 dynamics pass, and the
# robust family's entries of the later pairs (csrc/robust_<name>.cu)
_ROBUST_PAIRS = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
                 "di_quadratic", "bicycle_ar", "racer_steering_ar", "racer_unc_ar")
_ENTRY_LIBRARY = {
    **{(pair, "sample"): f"sample_{pair}"
       for pair in ("ar_nn", "racer_steering_ar", "racer_unc_ar", "racer_elev_susp_ar")},
    ("ar_nn", "split_dynamics_x0"): "split_x0_ar_nn",
    **{(pair, kind): f"robust_{pair}" for pair in _ROBUST_PAIRS for kind in _ROBUST
       if kind in PAIR_KERNELS[pair] and (pair, kind) != ("bicycle_ar", "rollout_x0")},
}


def pair_entry(pair: str, kind: str):
    """(library, C function) of kernel ``kind`` ("rollout", "rollout_x0",
    "solve", "sample", "rmppi" or one of the split form's) for the pair
    ``pair``, or None where it has no entry."""
    if kind not in PAIR_KERNELS.get(pair, ()):
        return None
    lib = _ENTRY_LIBRARY.get((pair, kind)) or _KIND_LIBRARY.get(
        kind, "pair_{pair}").format(pair=pair)
    return lib, _ENTRY_PREFIX[kind] + pair


SIGNATURES = {
    "flash_combine": {
        "kernel_block_size": [],
        "flash_combine_form": [],
        # device, carry, nb, TC, lam, new_mean, scal, num, stream
        "flash_combine": [_I, _P, _I, _I, _F, _P, _P, _P, _P],
        # the passes after the warp forms, launched alone (csrc/block_pass.cuh)
        "block_pass_form": [],
        # device, costs, X, K, TC, lam_w, carry, stream
        "block_carry_pass": [_I, _P, _P, _I, _I, _F, _P, _P],
        # device, costs, K, out, stream
        "block_min_pass": [_I, _P, _I, _P, _P],
    },
    "tsallis_reduce": {
        "tsallis_reduce_block_size": [],
        "tsallis_reduce_form": [],
        "tsallis_reduce": [
            _I, _P, _P, _P, _I,  # device, U, costs, rho source, its length
            _I, _I, _I, _F, _F,  # K valid, K rows, TC, gamma, 1 / (r - 1)
            _P, _P, _P,          # rows, rho, stream
        ],
    },
    "riccati": {
        "riccati_max_alphas": [],
        "riccati_ladder_form": [],
        "riccati_backward_form": [],
        "riccati_backward_s4c2": _BACKWARD,
        "riccati_backward_s4c1": _BACKWARD,
        "riccati_backward_s7c2": _BACKWARD,
        "riccati_ladder_di": _LADDER,
        "riccati_ladder_cartpole": _LADDER,
        "riccati_ladder_dubins": _LADDER,
        "riccati_ladder_ar_nn": _LADDER,
    },
}
# the entries with <entry>_form() beside them: 1 where the entry launches the
# warp form of its kernel (split_dynamics_warp_kernel,
# split_solve_dynamics_warp_kernel: csrc/split_warp.cuh;
# fused_sample_rollout_warp_kernel, with its epilogue's carry pass, and
# fused_solve_warp_kernel, with its carry pass: csrc/sample_warp.cuh;
# rollout_costs_warp_kernel, with its carry or minima pass:
# csrc/rollout_kernel.cuh;
# rmppi_rollout_warp_kernel: csrc/rmppi_warp.cuh), 2
# where the staged form of B4, B3, B1 or B8 (fused_sample_rollout_staged_kernel,
# fused_solve_staged_kernel, rollout_costs_staged_kernel:
# csrc/sample_staged.cuh; rmppi_rollout_staged_kernel: csrc/rmppi_staged.cuh)
# or of a split dynamics pass (split_dynamics_staged_kernel,
# split_solve_dynamics_staged_kernel: csrc/split_staged.cuh),
# 5 where the lane-group form of B1's split dynamics pass
# (split_dynamics_lanes_kernel: csrc/split_lanes.cuh), 0 where the
# one-thread kernel; the merge's
# flash_combine_form() says 4 for its tiled form (flash_combine_tiled_kernel),
# 0 for the one-block kernel (-DMPPI_COMBINE_ONE_BLOCK), and the Tsallis
# reduction's tsallis_reduce_form() the same (tsallis_reduce_tiled_kernel;
# tsallis_reduce_kernel with -DMPPI_TSALLIS_ONE_BLOCK); a split cost entry
# launches the form its caller names, and its _form() says 3 where the build
# has the cluster form (split_cost_cluster_kernel) beside the one-block
# split_cost_kernel, 0 where only the latter (-DMPPI_COST_ONE_BLOCK,
# csrc/split_kernels.cuh); the wrappers count each launch under its name.
# Every library with a B1, B3 or B4 entry also has block_pass_form(): 4 where
# the warp forms' passes are the tiled carry pass and the warp minima pass
# (block_carry_tiled_kernel, block_min_warp_kernel: csrc/block_pass.cuh), 0
# where the earlier block_carry_kernel and block_min_kernel
# (-DMPPI_PASS_UNSTAGED); riccati.cu's riccati_backward_form() says 1 for
# B6 over a warp (riccati_backward_warp_kernel), 0 for the one-thread
# riccati_backward_kernel (-DMPPI_BACKWARD_ONE_THREAD)
_PASS_KINDS = ("rollout", "rollout_x0", "solve", "sample")
_FORM_KINDS = ("split_dynamics", "split_solve_dynamics", "split_dynamics_x0", "sample",
               "rmppi", "solve", "rollout", "rollout_x0", "split_cost")
_KIND_SIGNATURE = {"rollout": _ROLLOUT, "rollout_x0": _ROLLOUT, "solve": _SOLVE,
                   "sample": _SAMPLE, "rmppi": _RMPPI, "split_dynamics": _SPLIT_DYNAMICS,
                   "split_solve_dynamics": _SPLIT_SOLVE_DYNAMICS, "split_cost": _SPLIT_COST,
                   "split_dynamics_x0": _SPLIT_DYNAMICS}
for _pair, _kinds in PAIR_KERNELS.items():
    for _kind in _kinds:
        _lib, _fn = pair_entry(_pair, _kind)
        SIGNATURES.setdefault(_lib, {})[_fn] = _KIND_SIGNATURE[_kind]
        if _kind in _FORM_KINDS:
            SIGNATURES[_lib][_fn + "_form"] = []
        if _kind in _PASS_KINDS:
            SIGNATURES[_lib]["block_pass_form"] = []

# launches of each CUDA kernel since the last reset_launch_counts(); each
# wrapper adds one where it launches its kernel, and one to entry_counts
# under the C function of a pair's entry (e.g. "fused_solve_cartpole")
entry_counts = {}
# the launches whose split choice (fused_rollout.resolve_split) a caller
# forced against AUTO since the last reset, by the form forced ("split" or
# "combined")
forced_routes = {}
launch_counts = {
    "rollout_costs_kernel": 0,
    "rollout_costs_staged_kernel": 0,
    "rollout_costs_warp_kernel": 0,
    "block_min_kernel": 0,
    "block_min_warp_kernel": 0,
    "flash_combine_kernel": 0,
    "flash_combine_tiled_kernel": 0,
    "tsallis_reduce_kernel": 0,
    "tsallis_reduce_tiled_kernel": 0,
    "rmppi_rollout_kernel": 0,
    "rmppi_rollout_warp_kernel": 0,
    "rmppi_rollout_staged_kernel": 0,
    "riccati_backward_kernel": 0,
    "riccati_backward_warp_kernel": 0,
    "riccati_ladder_kernel": 0,
    "riccati_ladder_warp_kernel": 0,
    "fused_solve_kernel": 0,
    "fused_solve_staged_kernel": 0,
    "fused_solve_warp_kernel": 0,
    "fused_sample_rollout_kernel": 0,
    "fused_sample_rollout_warp_kernel": 0,
    "fused_sample_rollout_staged_kernel": 0,
    "block_carry_kernel": 0,
    "block_carry_tiled_kernel": 0,
    "split_dynamics_kernel": 0,
    "split_solve_dynamics_kernel": 0,
    "split_dynamics_warp_kernel": 0,
    "split_dynamics_lanes_kernel": 0,
    "split_dynamics_staged_kernel": 0,
    "split_solve_dynamics_warp_kernel": 0,
    "split_solve_dynamics_staged_kernel": 0,
    "split_cost_kernel": 0,
    "split_cost_cluster_kernel": 0,
}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0
    entry_counts.clear()
    forced_routes.clear()


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
    return declare(ctypes.CDLL(build_all()[name]["path"]), name)


def declare(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """``lib``, a build of ``csrc/<name>.cu``, with the ``argtypes`` and
    ``restype`` of every function declared."""
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib
