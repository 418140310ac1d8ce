"""The lane-group form of the bicycle's split dynamics pass on the CPU: its
lane step and its data movement, emulated, against the plain versions bit
for bit.

``split_dynamics_lanes_kernel`` (``csrc/split_lanes.cuh``) runs B1's split
dynamics pass for the bicycle slip with a group of G = 8 lanes per sample
(``BicycleSlip::kLaneGroup``; blocks of 16 samples, 4 a warp). The lanes of
a group hold the same state and run ``BicycleSlip::step_lanes``
(``csrc/bicycle_slip.cuh``): lane l takes operand set l % 4 of each function
the step evaluates on
independent operands, and the results reach the group by ``__shfl_sync``:

* the divisions steer / steer_angle_scale (sets 0 and 2) and vx /
  wheel_base (1 and 3), then tan of the quotient (the wheel angle on the
  even sets);
* the tanh terms (A tanh((a b) c)) B: the brake force (0), the rolling drag
  (1), the sliding drag (2), tanh(vx omega y_f_c[0]) y_f_c[1] (3);
* sin and cos of the wheel angle (set 0) and of the yaw (the others);
* the divisions of the y (set 1) and x (the others) numerators by the mass.

The warp reads each 32-step chunk of its samples' controls, lane's floats
q * 32 + lane of the rows (a sample's 32 C floats contiguous in U), into a
padded shared buffer a chunk ahead; the lanes read a step's controls from
their sample's row. Each step lane l of a group stages outputs l, l + G,
... in one vector slot of the warp's chunk buffer; after the chunk the
block writes Y[t, o, k] four neighbouring samples a thread.

``lane_step`` emulates the step with the lanes and the sets written out
and ``lane_pass`` the pass's index arithmetic (the last block and the last
chunk ragged); the tests hold them bit for bit against the bicycle's plain
step (``kernel_step``) and ``split_outputs_plain``, and hold
that plain pass, through the split plain version of B1, against the JAX
package's split mode of ``_fused_call`` in interpret mode. The kernel itself
is held against the plain version on the card
(``tests/test_torch_cuda_kernels.py``, ``-k lanes``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.models import BicycleSlipDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_split_pairs import check_split_b1

CHUNK, BLOCK = 32, 16  # kChunk, kLaneSamples
G = 8  # BicycleSlip::kLaneGroup
DT = 0.02
# nonzero drag terms, so every parameter of the step takes part
PARAMS = dict(c_v_omega=0.1, c_vx=0.05, c_vy=0.07)


@pytest.fixture(autouse=True)
def one_thread():
    """One thread and TF32 off, as the kernels' bit-exact references run."""
    saved = (torch.get_num_threads(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(saved[0])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[1:]


def lane_step(dyn, x, u, t, dt):
    """BicycleSlip::step_lanes for a batch of samples (x (S, K), u (C,
    K)): each lane's operand set, the shuffles as reads of another lane's
    value, the rest of the step on one copy (every lane computes it alike).
    Returns (x_next, y)."""
    yaw, steer, brake = x[2], x[3], x[4]
    vx, vy, om = x[5], x[6], x[7]
    sets = [lane % 4 for lane in range(G)]
    q = [(vx if s & 1 else steer) / (dyn.wheel_base if s & 1 else dyn.steer_angle_scale)
         for s in sets]
    wa = [torch.tan(qq) for qq in q]  # the wheel angle on the even sets
    f = []
    for s in sets:
        a = (dyn.c_brake[1], dyn.c_rolling[1], dyn.c_sliding[1], vx)[s]
        b = (vx, vx, vy, om)[s]
        c = 1.0 if s < 3 else dyn.y_f_c[0]
        A = (dyn.c_brake[0], dyn.c_rolling[0], dyn.c_sliding[0], dyn.y_f_c[1])[s]
        B = brake if s == 0 else 1.0
        f.append((A * torch.tanh((a * b) * c)) * B)
    ang = [wa[lane] if s == 0 else yaw for lane, s in enumerate(sets)]
    wheel = wa[0]  # every lane, from lane 0
    sn = [torch.sin(a) for a in ang]
    cn = [torch.cos(a) for a in ang]
    sin_w, cos_w, sin_y, cos_y = sn[0], cn[0], sn[1], cn[1]

    tb, sc = u[0], u[1]
    enable_brake = tb < 0
    throttle = torch.where(enable_brake, 0.0, 1.0) * dyn.c_throttle * tb
    x_force = throttle - f[0] - f[1]
    y_force = f[3] - f[2]
    num_x = x_force + x_force * cos_w - y_force * sin_w
    num_y = y_force + y_force * cos_w + x_force * sin_w
    dv = [(num_y if s == 1 else num_x) / dyn.mass for s in sets]

    brake_d = torch.clamp((torch.where(enable_brake, -tb, 0.0) - brake) * dyn.brake_delay_constant,
                          -dyn.max_brake_rate_neg, dyn.max_brake_rate_pos)
    steer_d = torch.clamp((sc * dyn.steer_command_angle_scale - steer) * dyn.steering_constant,
                          -dyn.max_steer_rate, dyn.max_steer_rate)
    omega_d = (q[1] * wheel - om) * dyn.c_omega - om * dyn.c_v_omega
    vx_d = dv[0] - vx * dyn.c_vx + vy * om
    vy_d = dv[1] - vy * dyn.c_vy - vx * om
    zero = torch.zeros_like(vx_d)
    xdot = torch.stack([vx * cos_y - vy * sin_y, vx * sin_y + vy * cos_y, om, steer_d,
                        brake_d, vx_d, vy_d, omega_d, zero, zero])
    x_next = dyn.update_state(x, xdot, dt)
    return x_next, dyn.state_to_output(x_next)


def lane_pass(dyn, x0, U, dt):
    """The lane-group pass: Y (T, O, K) as the kernel writes it."""
    K, T, C = U.shape
    O = dyn.OUTPUT_DIM
    NW = 32 // G  # samples a warp
    row = CHUNK * C  # a sample's controls of a chunk
    per = NW * row // 32  # the floats of them a lane fetches
    outs = -(-O // G)
    n_slots = 1 if outs <= 1 else 2 if outs <= 2 else 4
    n_blocks = -(-K // BLOCK)
    n_warps = n_blocks * (BLOCK // NW)
    flat = U.reshape(-1)
    # each warp's shared rows of controls, padded to row + 1, and its staged
    # outputs: step j, lane, slot
    uw = torch.full((n_warps, NW, row + 1), float("nan"))
    y_s = torch.full((n_warps, CHUNK, 32, n_slots), float("nan"))
    # the valid samples' state, as the plain version holds it (a group past K
    # steps a zero state the kernel never stores)
    x = x0[:, None].expand(-1, K)
    Y = torch.full((T, O, K), float("nan"))
    lanes = torch.arange(32)
    ks = torch.arange(K)
    w_of, g_of = ks // NW, ks % NW  # the warp and the group of each sample
    for ch in range(-(-T // CHUNK)):
        t0 = ch * CHUNK
        for w in range(n_warps):
            wbase = w * NW  # blockIdx.x * BLOCK + (warp of the block) * NW
            for q in range(per):
                f = q * 32 + lanes
                kk, idx = wbase + f // row, ch * row + f % row
                ok = (kk < K) & (idx < T * C)
                pre = torch.where(ok, flat[torch.where(ok, kk * T * C + idx, 0)], 0.0)
                uw[w, f // row, f % row] = pre
        n = min(CHUNK, T - t0)
        for j in range(n):
            u = torch.stack([uw[:, :, j * C + c].reshape(-1)[:K] for c in range(C)])
            x, y = lane_step(dyn, x, u, float(t0 + j), dt)
            for lane_l in range(G):  # lane (g, l) stages outputs l, l + G, ...
                for e in range(n_slots):
                    o = e * G + lane_l
                    y_s[w_of, j, g_of * G + lane_l, e] = y[o] if o < O else 0.0
        # the block's write-out: four neighbouring samples of one (step,
        # output) a thread
        for b in range(n_blocks):
            bbase = b * BLOCK
            for f in range(n * O * (BLOCK // 4)):
                j, o, s0 = f // (O * BLOCK // 4), (f // (BLOCK // 4)) % O, 4 * (f % (BLOCK // 4))
                for e in range(4):
                    sb = s0 + e
                    if bbase + sb < K:
                        w = b * (BLOCK // NW) + sb // NW
                        Y[t0 + j, o, bbase + sb] = y_s[w, j, (sb % NW) * G + o % G, o // G]
    return Y


def _states(K, seed):
    """Random bicycle states and controls: both signs of the throttle (the
    brake path), steer angles and commands across their clamps, yaws past
    pi."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor([5.0, 5.0, 9.0, 0.7, 1.0, 6.0, 2.0, 3.0, 0.1, 0.1])[:, None]
    x = scale * (2.0 * torch.rand((10, K), generator=g) - 1.0)
    x[4] = x[4].abs()
    u = 1.2 * (2.0 * torch.rand((2, K), generator=g) - 1.0)
    return x, u


@pytest.mark.parametrize("seed", [4, 8])
def test_lane_step_matches_the_plain_step(seed):
    dyn = BicycleSlipDynamics.create(**PARAMS)
    x, u = _states(4096, seed)
    for t in range(3):
        want_x, want_y = dyn.kernel_step(x, u, float(t), DT)
        got_x, got_y = lane_step(dyn, x, u, float(t), DT)
        assert torch.isfinite(want_x).all()
        assert torch.equal(got_x, want_x) and torch.equal(got_y, want_y)
        x = want_x


@pytest.mark.parametrize("K,T", [(130, 100), (130, 31), (61, 33), (3, 20), (16, 32),
                                 (17, 64), (64, 1), (45, 65)])
def test_lane_pass_matches_split_outputs_plain(K, T):
    dyn = BicycleSlipDynamics.create(**PARAMS)
    g = torch.Generator().manual_seed(K + T)
    U = torch.tensor([0.3, 0.5]) * torch.randn((K, T, 2), generator=g) + torch.tensor(
        [0.2, 0.0])
    x0 = torch.zeros(10)
    x0[5] = 3.0
    want = fr.split_outputs_plain(dyn, x0, U, DT).permute(1, 2, 0)  # (T, O, K)
    got = lane_pass(dyn, x0, U, DT)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["costs", "costs+lr"])
def test_split_plain_pass_matches_the_jax_split_mode(mode):
    """split_rollout_plain (its dynamics pass is split_outputs_plain) against
    JAX's _fused_call with split_cost=True in interpret mode, for the
    bicycle with the AutoRally cost, K = 128 at T = 33 (two chunks of the
    lane pass, one ragged); the tolerances of test_torch_split_pairs.py."""
    check_split_b1("bicycle_ar", mode, K=128, T=33)
