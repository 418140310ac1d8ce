"""The network pairs' combined B3 in its warp form, and the tiled B5, timed
against what they replace and against B3's split form.

For AutoRally (1920 x 150, the bench's 128^2 map), the racer LSTM-steering
row (1920 x 100) and the LSTM-uncertainty row (1920 x 150), Gaussian and
NLN, this script launches B3 through ``fused_solve.fused_solve_carries``:

* the warp form (``fused_solve_warp_kernel`` and its carry pass) A B B A
  against the one-thread ``fused_solve_kernel`` of the same sources built
  with -DMPPI_SOLVE_ONE_THREAD (``chip_smoke.py``'s variant, which also
  builds the one-thread B1 there; CUDA events, medians of 100 runs; the
  profiler's device time too), after checking that both give the same bits;
* the combined kernel (``split_cost=False``) against the split form
  (``split_cost=True``): combined, split, split, combined, the A B B A that
  sets the pair's ``("...", "solve")`` row of ``fr.AUTO_SPLIT``: the split
  only where both split times are below both combined times.

Then the Tsallis reduction at the colored row's 8192 x 100 (and the
bicycle's 1920 x 100): the tiled kernel A B B A against the one-block build
(-DMPPI_TSALLIS_ONE_BLOCK), rows and rho checked bit for bit. Prints the
card (``nvidia-smi``), the ptxas lines of the new kernels and one JSON line
per case; needs a CUDA card with nvcc:

    python3 scripts/torch_network_solve_abba.py
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mppi_generic_tpu_torch.ops import _build, fused_solve  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout as fr  # noqa: E402


def network_parts(pair, dev):
    """(dynamics, cost, x0, K, T) of a network pair's bench row."""
    if pair == "ar_nn":
        return (*cs.ar_parts("128", dev), cs.ar_x0(dev), cs.K_AR, cs.T_AR)
    return (*cs.racer_parts(pair, dev), cs.racer_x0(pair, dev), cs.K_RC, cs.T_RACER[pair])


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = _build.build_all()
    logs = cs.build_variants(tuple(v for v in cs.VARIANTS if v[0] is cs.SOLVE_ONE_THREAD) + (
        (cs.EARLIER, cs.EARLIER_DEFINES, "earlier_forms", ("tsallis_reduce",)),))
    keep = ("registers", "Compiling entry", "stack frame")
    for name, log in [(n, built[n]["log"]) for n in cs.WARP_SOLVE_SOURCES + ("tsallis_reduce",)]:
        lines = [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]
        print(json.dumps({"ptxas": name, "lines": lines}), flush=True)
    for key, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]
        print(json.dumps({"ptxas": key, "lines": lines}), flush=True)

    for pair in cs.WARP_PAIRS:
        dyn, cost, x0, K, T = network_parts(pair, dev)
        g = torch.Generator(device=dev).manual_seed(K + T)
        mean = 0.2 * torch.randn((T, cs.C), generator=g, device=dev)
        seed = torch.tensor(K + 1, dtype=torch.int32, device=dev)
        for kind in ("gaussian", "nln"):
            samp = cs.ar_sampler(kind, dev)
            args = (dyn, cost, samp, x0, mean, seed, cs.DT, cs.LAM, cs.ALPHA, K)

            def solve(split, args=args):
                return fused_solve.fused_solve_carries(*args, split_cost=split)

            got = solve(False)
            with cs.one_thread_solve():
                one = solve(False)
            torch.cuda.synchronize()
            cs.same_bits(f"{pair} {kind}", got, one)
            row = {"pair": pair, "kind": kind, "K": K, "T": T, "form": cs.b3_kernel(pair),
                   "one_thread_abba": cs.abba_against(lambda: solve(False), cs.one_thread_solve),
                   "split_abba": cs.abba(lambda: solve(False), lambda: solve(True))}
            if kind == "gaussian":
                row["one_thread_device"] = cs.device_abba(
                    lambda: solve(False), ("fused_solve_warp_kernel", cs.CARRY),
                    "fused_solve_kernel", cs.one_thread_solve)
                row["warp_kernel_device_ms"] = cs.device_ms(lambda: solve(False),
                                                            "fused_solve_warp_kernel")
                row["carry_pass_device_ms"] = cs.device_ms(lambda: solve(False), cs.CARRY)
            print(json.dumps(row), flush=True)

    for K, T in ((8192, 100), (1920, 100)):
        g = torch.Generator(device=dev).manual_seed(K)
        U = torch.randn((K, T, cs.C), generator=g, device=dev)
        costs = 1.0 + torch.rand((K,), generator=g, device=dev)
        minima = fr.block_minima_plain(costs)

        def b5():
            return fr.tsallis_block_rows(U, costs, minima, cs.GAMMA, cs.R_TS)

        got = b5()
        with cs.earlier_forms():
            one = b5()
        torch.cuda.synchronize()
        cs.same_bits(f"B5 {K} x {T}", got, one)
        print(json.dumps({"kernel": fr.tsallis_kernel_name(), "K": K, "T": T,
                          "one_block_abba": cs.abba_against(b5, cs.earlier_forms),
                          "one_block_device": cs.device_abba(
                              b5, cs.TSALLIS, "tsallis_reduce_kernel", cs.earlier_forms),
                          "bound_ms": cs.bound_ms(*cs.tsallis_reduce_work(K, T))[0]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
