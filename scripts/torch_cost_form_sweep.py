"""The split cost pass's two forms across shapes: where the cluster form wins.

``fused_rollout.split_cost_cuda`` launches ``split_cost_cluster_kernel`` (a
thread-block cluster of 8 CTAs a 64-sample block) or the one-block
``split_cost_kernel``, as ``fused_rollout.split_cost_form`` picks. This
script launches both forms of the port's build at each (pair, K, T) of
SHAPES on the outputs of the port's dynamics pass (``chip_smoke``'s split
inputs, the exp epilogue without LR), checks that they give the same bits,
and times them A B B A: one-block, cluster, cluster, one-block (CUDA events,
medians of 100 runs). One JSON line per shape, with the form the rule picks
there and whether that form won both turns; needs a CUDA card with nvcc:

    python3 scripts/torch_cost_form_sweep.py
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mppi_generic_tpu_torch.ops import _build  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout as fr  # noqa: E402

# the paths' shapes (the hover's split loops, RMPPI's DI robust candidates,
# the network pairs' and the bicycle's K = 1920), K past 2304 up to the
# flagship's 8192, and short horizons of the map costs
SHAPES = (
    ("quadrotor_quadratic", 512, 48), ("quadrotor_quadratic", 1920, 100),
    ("quadrotor_quadratic", 8192, 100),
    ("di_robust", 576, 48), ("di_robust", 2304, 48), ("di_robust", 576, 100),
    ("di_circle", 576, 48), ("di_circle", 1920, 100), ("di_circle", 4224, 100),
    ("di_circle", 8192, 100),
    ("di_quadratic", 1920, 100), ("dubins_quadratic", 1920, 100), ("cartpole", 1920, 100),
    ("cartpole", 8192, 100),
    ("ar_nn", 576, 48), ("ar_nn", 1920, 48), ("ar_nn", 1920, 150), ("ar_nn", 2304, 150),
    ("ar_nn", 3072, 150), ("ar_nn", 4224, 150), ("ar_nn", 4288, 150), ("ar_nn", 5120, 150),
    ("ar_nn", 6144, 150), ("ar_nn", 8192, 150),
    ("bicycle_ar", 576, 48), ("bicycle_ar", 1920, 100), ("bicycle_ar", 4224, 100),
    ("bicycle_ar", 8192, 100),
    ("racer_steering_ar", 1920, 100), ("racer_steering_ar", 8192, 100),
    ("racer_unc_ar", 1920, 150),
)
CLUSTER, ONE_BLOCK = 3, 0


def case(dev, pair, K, T_):
    """(dynamics, cost, Y (T_, O, K), U (K, T_, C)) at this shape: the first
    T_ steps of the pair's split inputs, through the port's dynamics pass
    (from one x0 per sample where the pair has no other)."""
    dyn, cost, x0, _, U, _, _, _ = cs.split_inputs(dev, pair, K, 0.0, 0, 501 + K + T_,
                                                   "128" if pair == "ar_nn" else None)
    U = U[:, :T_].contiguous()
    if "split_dynamics" not in _build.PAIR_KERNELS[pair]:
        x0 = x0.expand(K, -1).contiguous()
    return dyn, cost, fr.split_dynamics_cuda(dyn, cost, x0, U, cs.DT), U


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cost_form_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.build_all()
    for pair, K, T_ in SHAPES:
        dyn, cost, Y, U = case(dev, pair, K, T_)
        run = {f: (lambda f=f: fr.split_cost_cuda(dyn, cost, Y, U, None, fr.EPI_EXP, cs.LAM,
                                                  form=f))
               for f in (CLUSTER, ONE_BLOCK)}
        cs.same_bits(f"{pair} K={K} T={T_}", run[CLUSTER](), run[ONE_BLOCK]())
        a1, b1 = cs.time_ms(run[ONE_BLOCK], cs.N_TIMED), cs.time_ms(run[CLUSTER], cs.N_TIMED)
        b2, a2 = cs.time_ms(run[CLUSTER], cs.N_TIMED), cs.time_ms(run[ONE_BLOCK], cs.N_TIMED)
        entry, dual = _build.pair_entry(pair, "split_cost"), cost.time_parallel_crash()
        picked = fr.split_cost_form(entry, 0, K, T_, dual)
        cluster_wins, one_block_wins = max(b1, b2) < min(a1, a2), max(a1, a2) < min(b1, b2)
        print(json.dumps({
            "pair": pair, "K": K, "T": T_, "blocks": -(-K // fr.BLOCK),
            "cluster_ms": (b1 + b2) / 2, "one_block_ms": (a1 + a2) / 2,
            "abba_ms": [a1, b1, b2, a2], "cluster_won_both": cluster_wins,
            "one_block_won_both": one_block_wins,
            "rule_picks": fr.split_cost_kernel_name(entry, 0, K, T_, dual),
            "pick_won_both": cluster_wins if picked == CLUSTER else one_block_wins}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
