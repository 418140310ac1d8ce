"""Empirical kernel choice, the counterpart of ``mppi_generic_tpu/ops/autotune.py``.

The reference's ``chooseAppropriateKernel`` (mppi_controller.cu:45-143)
times its single-kernel and split-kernel rollouts at construction and keeps
the faster. ``choose_appropriate_kernel`` times the controller's kernel
paths ("combined" and "split", the eager rollouts; "fused", the rollout
kernel B1; "fused_solve", the fused solve B3), keeps the fastest, and then
times the winner's two kernel forms (``split_cost`` False and True) where
the cost is eligible for the split. The choice is cached per configuration
in the process and on disk.

JAX's tuner also sweeps the TPU's sample tile (multiples of its 128
lanes). The port's kernels fix their block at ``kBlockSamples`` = 64
samples (``csrc/mppi_common.cuh``), one thread (or, in the split cost
pass, one warp) per sample, so there is no tile to sweep.

Times come from CUDA events on the card and from ``time.perf_counter`` on
the CPU: the slope between chains of n and 2n state-threaded solves, so a
fixed per-chain cost cancels, the median of three.

The disk cache is one JSON file, ``autotune.json``, in
``MPPI_TUNE_CACHE_DIR`` or else in ``build/torch_autotune/`` at the root of
the checkout (beside the built kernels, git-ignored). ``MPPI_RETUNE=1`` (or
``retune=True``) times again and overwrites both caches.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import time
from pathlib import Path

import torch

from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr

__all__ = ["DEFAULT_CANDIDATES", "choose_appropriate_kernel", "time_solve"]

DEFAULT_CANDIDATES = ("combined", "split", "fused", "fused_solve")
_CACHE: dict = {}
_DISK: dict | None = None


def _disk_path() -> Path:
    root = os.environ.get("MPPI_TUNE_CACHE_DIR")
    base = Path(root) if root else _build.BUILD_ROOT.parent / "torch_autotune"
    return base / "autotune.json"


def _disk_load() -> dict:
    global _DISK
    if _DISK is None:
        try:
            _DISK = json.loads(_disk_path().read_text())
        except (OSError, ValueError):
            _DISK = {}
    return _DISK


def _disk_store(key: str, decision) -> None:
    """Write ``decision`` under ``key``, merged into the file's current
    contents (another process may have stored its own since this one read
    it); a read-only location leaves the in-process cache working."""
    path = _disk_path()
    try:
        try:
            merged = json.loads(path.read_text())
        except (OSError, ValueError):
            merged = {}
        merged[key] = list(decision)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        tmp.write_text(json.dumps(merged, indent=0))
        os.replace(tmp, path)
    except OSError:
        return
    _disk_load().clear()
    _DISK.update(merged)


def _device_name(controller) -> str:
    dev = controller.device
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _config_key(controller, candidates) -> str:
    """The configuration a choice holds for: the classes, K, T, the split
    choice, the candidates, the names and shapes of the dynamics' and the
    cost's buffers and parameters (a map attached or not changes them),
    the device's name and the torch and CUDA versions."""
    shapes = tuple(
        (name, tuple(t.shape))
        for module in (controller.dynamics, controller.cost)
        for name, t in [*module.named_buffers(), *module.named_parameters()])
    return repr((
        type(controller).__name__, type(controller.dynamics).__name__,
        type(controller.cost).__name__, type(controller.sampler).__name__,
        int(controller.num_rollouts), int(controller.num_timesteps),
        controller.split_cost, tuple(candidates), shapes, _device_name(controller),
        torch.__version__, torch.version.cuda))


def _has_entry(controller, kind) -> bool:
    pair = fr._PAIRS.get((type(controller.dynamics), type(controller.cost)))
    return pair is not None and _build.pair_entry(pair, kind) is not None


def _kernel_supported(controller, name) -> bool:
    """The port's own gates: the controller takes the kernel name; on the
    card, "fused" and "fused_solve" need the pair's entry for the kernel
    the path launches; "fused_solve" needs a sampler whose noise the
    kernels draw."""
    if name not in controller.KERNELS:
        return False
    if name == "fused_solve":
        try:
            kind = fr.noise_kind(controller.sampler)
        except NotImplementedError:
            return False
    if controller.device.type != "cuda" or name in ("combined", "split"):
        return True
    name = getattr(controller, "equivalent_kernels", {}).get(name, name)
    if name == "fused" and hasattr(controller, "samples_per_condition"):
        return _has_entry(controller, "rollout_x0") and _has_entry(controller, "rmppi")
    if name == "fused":
        return _has_entry(controller, "rollout")
    exp = (getattr(controller, "weight_transform", "exp") == "exp"
           and getattr(controller, "shaping_function", None) is None)
    return _has_entry(controller, "solve" if exp and kind != fr.SMOOTH else "sample")


def _with(controller, kernel=None, split_cost=None):
    """A shallow copy of ``controller`` with another kernel path and split
    choice; the modules are shared."""
    out = copy.copy(controller)
    if kernel is not None:
        out.kernel = getattr(controller, "equivalent_kernels", {}).get(kernel, kernel)
    out.split_cost = split_cost
    return out


def _solve_chain(controller, x0, state, n):
    for _ in range(n):
        _, state = controller.solve(x0, state)
    return state


def time_solve(controller, x0, ctrl_state, num_evaluations=10, repeats=3) -> float:
    """Seconds per solve: the slope (t_2n - t_n) / n between chains of n and
    2n state-threaded solves, n = ``num_evaluations``, the median of
    ``repeats``; CUDA events on the card, ``perf_counter`` on the CPU."""
    n = max(int(num_evaluations), 1)
    cuda = controller.device.type == "cuda"
    _solve_chain(controller, x0, ctrl_state, 2)  # first launches, allocations
    slopes = []
    for _ in range(repeats):
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            _solve_chain(controller, x0, ctrl_state, n)
            ev[1].record()
            _solve_chain(controller, x0, ctrl_state, 2 * n)
            ev[2].record()
            torch.cuda.synchronize()
            t_n = 1e-3 * ev[0].elapsed_time(ev[1])
            t_2n = 1e-3 * ev[1].elapsed_time(ev[2])
        else:
            t0 = time.perf_counter()
            _solve_chain(controller, x0, ctrl_state, n)
            t1 = time.perf_counter()
            _solve_chain(controller, x0, ctrl_state, 2 * n)
            t_n, t_2n = t1 - t0, time.perf_counter() - t1
        slopes.append((t_2n - t_n) / n)
    return max(statistics.median(slopes), 1e-9)


def choose_appropriate_kernel(controller, x0, ctrl_state=None,
                              candidates=DEFAULT_CANDIDATES, num_evaluations=10,
                              retune=False, timings=None):
    """A copy of ``controller`` with the fastest kernel path of
    ``candidates`` and, for a kernel path whose cost is eligible for the
    split form (``split_cost`` None), the faster of its two forms.

    A candidate the controller does not support (``_kernel_supported``) or
    that raises NotImplementedError (no kernel entry) is skipped. The
    choice is cached per configuration (``_config_key``) in the process and
    on disk; ``retune`` (or ``MPPI_RETUNE=1``) times again. ``timings``, a
    dict, receives each timed candidate's seconds per solve."""
    key = _config_key(controller, candidates)
    retune = retune or os.environ.get("MPPI_RETUNE") == "1"
    hit = None if retune else _CACHE.get(key)
    if hit is None and not retune:
        hit = _disk_load().get(key)
    if hit is not None and _kernel_supported(controller, hit[0]):
        _CACHE[key] = tuple(hit)
        return _with(controller, hit[0], hit[1])
    if ctrl_state is None:
        ctrl_state = controller.init_state(0)
    timings = {} if timings is None else timings
    aliases = getattr(controller, "equivalent_kernels", {})
    seen, best, best_t = set(), None, None
    for name in candidates:
        canonical = aliases.get(name, name)
        if canonical in seen or not _kernel_supported(controller, canonical):
            continue
        seen.add(canonical)
        try:
            t = time_solve(_with(controller, canonical, controller.split_cost), x0,
                           ctrl_state, num_evaluations)
        except NotImplementedError:
            if canonical in ("combined", "split"):
                raise
            continue
        timings[canonical] = t
        if best_t is None or t < best_t:
            best, best_t = canonical, t
    if best is None:  # nothing ran: keep the controller as it is
        return controller
    split = controller.split_cost
    if (best in ("fused", "fused_solve") and split is None
            and fr.split_eligible(controller.cost)):
        # the winner's two forms, timed as the reference times its single
        # and split kernels (JAX autotune.py:340-371)
        timed = {}
        for form in (False, True):
            try:
                timed[form] = time_solve(_with(controller, best, form), x0,
                                         ctrl_state, num_evaluations)
            except NotImplementedError:
                continue
            timings[f"{best} split_cost={form}"] = timed[form]
        if len(timed) == 2:
            split = timed[True] < timed[False]
    _CACHE[key] = (best, split)
    _disk_store(key, (best, split))
    return _with(controller, best, split)
