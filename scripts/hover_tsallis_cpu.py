"""The quadrotor hover with Tsallis weights on the CPU: the JAX controller's
own loop and the PyTorch port's loop, side by side.

The hover's bar (tests/test_model_zoo.py:60-92: position error < 0.5 m after
150 steps) is set for normExp weights. chip_smoke.py runs the hover with
Tsallis weights (gamma 10, r 2) on ``kernel="fused_solve"`` for 100 steps
and holds it to finite states only. This script runs that configuration
(K=512, T=48, dt 0.02, lambda 1, alpha 0, std (0.5, 0.5, 0.5, 2), no control
cost, the offset start (1, 0, -0.5), hover thrust 9.81 as the initial mean)
in both packages on the CPU, for several seeds, and prints the position
error after 100 and 150 steps and its minimum over the loop:

    python3 scripts/hover_tsallis_cpu.py [--seeds 0,1,2,3] [--weights tsallis]

The two packages draw different samples from the same seed, so the
comparison is between the spreads of the seeds, not step by step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mppi_generic_tpu.controllers.vanilla import VanillaMPPI as JaxVanilla  # noqa: E402
from mppi_generic_tpu.costs.quadrotor import QuadrotorQuadraticCost as JaxCost  # noqa: E402
from mppi_generic_tpu.models.quadrotor import QuadrotorDynamics as JaxQuad  # noqa: E402
from mppi_generic_tpu.sampling.gaussian import GaussianDistribution as JaxGauss  # noqa: E402
from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI  # noqa: E402
from mppi_generic_tpu_torch.costs import QuadrotorQuadraticCost  # noqa: E402
from mppi_generic_tpu_torch.models import QuadrotorDynamics  # noqa: E402

K, T, STEPS, DT = 512, 48, 150, 0.02
RANGES = [[-3.0, 3.0]] * 3 + [[0.0, 20.0]]
STD = [0.5, 0.5, 0.5, 2.0]
GAMMA, R = 10.0, 2.0


def jax_loop(seed, weights):
    dyn = JaxQuad.create(control_ranges=RANGES)
    ctrl = JaxVanilla(dynamics=dyn, cost=JaxCost(x_coeff=jnp.float32(50.0),
                                                 v_coeff=jnp.float32(5.0)),
                      sampler=JaxGauss.create(std_dev=STD, control_cost_coeff=[0.0] * 4),
                      dt=jnp.float32(DT), lam=jnp.float32(1.0), alpha=jnp.float32(0.0),
                      num_timesteps=T, num_rollouts=K, weight_transform=weights,
                      tsallis_gamma=jnp.float32(GAMMA), tsallis_r=jnp.float32(R))
    x = dyn.get_zero_state().at[0].set(1.0).at[2].set(-0.5)
    cs = ctrl.init_state(jax.random.PRNGKey(seed),
                         initial_mean=jnp.tile(jnp.array([0.0, 0.0, 0.0, 9.81]), (T, 1)))

    def body(carry, _):
        x, cs = carry
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        return (x, cs), x

    _, xs = jax.jit(lambda x, cs: jax.lax.scan(body, (x, cs), None, length=STEPS))(x, cs)
    return np.asarray(xs)


def port_loop(seed, weights):
    dyn = QuadrotorDynamics.create(control_ranges=RANGES, device="cpu")
    ctrl = VanillaMPPI(dyn, QuadrotorQuadraticCost(x_coeff=50.0, v_coeff=5.0, device="cpu"),
                       GaussianDistribution.create(std_dev=STD, control_cost_coeff=[0.0] * 4,
                                                   device="cpu"),
                       dt=DT, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K, num_iters=1,
                       kernel="fused_solve", weight_transform=weights, tsallis_gamma=GAMMA,
                       tsallis_r=R, split_cost=False, device="cpu")
    x = torch.zeros(13)
    x[6], x[0], x[2] = 1.0, 1.0, -0.5
    cs = ctrl.init_state(seed=seed, initial_mean=torch.tensor([0.0, 0.0, 0.0, 9.81]).expand(T, 4))
    xs = []
    for _ in range(STEPS):
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        x = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)[0]
        xs.append(x.numpy().copy())
    return np.stack(xs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--weights", default="tsallis", choices=("tsallis", "exp"))
    args = ap.parse_args()
    torch.set_num_threads(2)
    for impl, loop in (("jax", jax_loop), ("port", port_loop)):
        for seed in (int(s) for s in args.seeds.split(",")):
            err = np.linalg.norm(loop(seed, args.weights)[:, :3], axis=1)
            print(json.dumps({"impl": impl, "weights": args.weights, "seed": seed,
                              "position_error_100": float(err[99]),
                              "position_error_150": float(err[149]),
                              "min_position_error": float(err.min())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
