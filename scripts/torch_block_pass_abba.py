"""The passes after the warp forms (the tiled carry pass, the warp minima
pass) and B6 over a warp, checked and timed against what they replace.

This script

* prints the ptxas lines (registers, stack, spill) of the new kernels
  (``block_carry_tiled_kernel``, ``block_min_warp_kernel``,
  ``riccati_backward_warp_kernel``) and of the warp kernels that launch the
  passes (``fused_solve_warp_kernel``, ``rollout_costs_warp_kernel``,
  ``fused_sample_rollout_warp_kernel``);
* runs ``chip_smoke.pass_forms_phase``: each pass against its plain version
  and its earlier build bit for bit, the passes alone and AutoRally's warp
  B3, B1 and B4 with their pass A B B A against -DMPPI_PASS_UNSTAGED;
* runs ``chip_smoke.riccati_phase``: B6 on the DI task's linearisation
  (T = 50) against its plain version and A B B A against
  -DMPPI_BACKWARD_ONE_THREAD, and prints that A B B A;
* with ``--other DIR`` (a checkout, e.g. the parent unpacked by ``git
  archive`` under ``build/``), compiles that checkout's sources of the same
  names beside the port's build and prints their ptxas lines beside the
  port's, so that the warp kernels' registers, stack and spill can be read
  against the other checkout's (the timings against the earlier passes run
  on this checkout's -DMPPI_PASS_UNSTAGED build).

Needs a CUDA card with nvcc; a few minutes on an H100 with the builds:

    python3 scripts/torch_block_pass_abba.py [--other build/parent]
"""

import argparse
import concurrent.futures
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mppi_generic_tpu_torch.ops import _build  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout as fr  # noqa: E402

# the sources whose warp kernels launch the passes, and B6's
SOURCES = tuple(sorted({_build.pair_entry(p, k)[0] for p in cs.WARP_PAIRS
                        for k in ("solve", "sample", "rollout_x0")
                        if _build.pair_entry(p, k)})) + ("flash_combine", "riccati")
KERNELS = ("block_carry", "block_min", "riccati_backward", "_warp_kernel")


def ptxas_table(log):
    """{demangled kernel: (registers, stack bytes, spill stores, spill loads)}
    of the kernels named in KERNELS in an nvcc log with -Xptxas -v."""
    out, name, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip()
            name = re.sub(r"\(anonymous namespace\)::", "", name).split("(")[0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill",
                      line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None and any(k in name for k in KERNELS):
            out[name] = (int(m.group(1)), *frame)
            name = None
    return out


def compile_other(csrc, names):
    """nvcc's logs of the sources ``names`` of another checkout's ``csrc``
    (compiled with the port's flags into build/other_build, not loaded: an
    earlier checkout lacks some of the functions this one declares)."""
    out = _build.BUILD_ROOT / "other_build"
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out / f"lib{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names}
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"other build of {name} failed:\n{logs[name]}")
    return logs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout whose sources' ptxas lines to print beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    variants = tuple(v for v in cs.VARIANTS
                     if v[0] is cs.PASS_UNSTAGED or v[0] is cs.LADDER_ONE_THREAD)
    other_logs = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        pending = None
        if opts.other:
            pending = pool.submit(compile_other, Path(opts.other).resolve()
                                  / "mppi_generic_tpu_torch" / "csrc", SOURCES)
        variant_logs = pool.submit(cs.build_variants, variants)
        built = _build.build_all()
        variant_logs = variant_logs.result()
        if pending is not None:
            other_logs = pending.result()
    for name in SOURCES:
        table = ptxas_table(built[name]["log"])
        other = ptxas_table(other_logs[name]) if name in other_logs else {}
        for kern, regs in sorted(table.items()):
            row = {"ptxas": name, "kernel": kern, "registers_stack_spill_stores_loads": regs}
            if name in other_logs:
                row["other"] = other.get(kern)
            print(json.dumps(row), flush=True)
    for key, log in sorted(variant_logs.items()):
        for kern, regs in sorted(ptxas_table(log).items()):
            if "block_" in kern or "riccati_backward" in kern:  # the earlier builds
                print(json.dumps({"ptxas": key, "kernel": kern,
                                  "registers_stack_spill_stores_loads": regs}), flush=True)
    for lib in SOURCES[:-1]:  # the builds report the forms they launch
        names = (fr.pass_kernel_name("block_carry", lib), fr.pass_kernel_name("block_min", lib))
        if names != (cs.CARRY, cs.MIN_PASS):
            raise AssertionError(f"{lib} reports {names}")
    with cs.unstaged_passes():
        names = fr.pass_kernel_name("block_carry"), fr.pass_kernel_name("block_min")
    if names != ("block_carry_kernel", "block_min_kernel"):
        raise AssertionError(f"the earlier passes' build reports {names}")
    with cs.one_thread_ladder():
        one = cs.riccati.backward_kernel_name()
    if (cs.riccati.backward_kernel_name(), one) != (cs.BACKWARD, "riccati_backward_kernel"):
        raise AssertionError(f"the B6 builds report {cs.riccati.backward_kernel_name()}, {one}")
    cs.pass_forms_phase(dev)
    cs.riccati_phase(dev)
    print(json.dumps({"B6_abba": {label: t for (kind, label), t in cs.PASS_TIMES.items()
                                  if kind == "backward"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
