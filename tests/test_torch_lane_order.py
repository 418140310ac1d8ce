"""The lane order of the warp form of the network steps, on the CPU.

The split dynamics passes of the network models run one warp per sample
(``csrc/split_warp.cuh``): lane o computes output unit o of each layer from a
table laid out for the lanes (``FNN3::warp_slot``, ``LSTMNet::warp_slot``),
a layer's inputs reaching each lane by a shuffle from lane j in the order
j = 0..N-1, and an LSTM's gates split (i, f) on lanes 0-15 and (o, c) on
lanes 16-31. This file emulates that computation with the lanes as a
tensor axis (elementwise float32 operations, the kernel's order) from a
table permuted by a Python mirror of the kernels' ``warp_slot``, and holds
it against ``FNN.forward_axis0_plain`` and ``LSTM.forward_axis0_plain`` (the
kernels' plain versions) bit for bit, for the four networks the kernels are
built for. It pins the order and the table layout the kernel must keep; the
kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``-k warp``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.nn import FNN, LSTM
from mppi_generic_tpu_torch.nn.lstm import sigmoid

LANES = 32
BATCH = 48


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def transposed_slot(i, off, n_in, n_out):
    """csrc/warp.cuh transposed_slot: W (OUT, IN) at ``off`` stored as W^T."""
    r = i - off
    return i if r >= n_in * n_out else off + (r % n_in) * n_out + r // n_in


def fnn_warp_slot(i, layers):
    """csrc/fnn.cuh FNN3::warp_slot for layers (N0, N1, N2, N3)."""
    n0, n1, n2, n3 = layers
    l2 = n1 * n0 + n1
    l3 = l2 + n2 * n1 + n2
    if i < l2:
        return transposed_slot(i, 0, n0, n1)
    if i < l3:
        return transposed_slot(i, l2, n1, n2)
    return transposed_slot(i, l3, n2, n3)


def lstm_warp_slot(i, I, H, N1, NO):
    """csrc/lstm.cuh LSTMNet::warp_slot."""
    k_wi, k_b = 4 * H * H, 4 * H * (H + I)
    k_w1 = 4 * H * (H + I) + 4 * H
    k_w2 = k_w1 + N1 * (H + I) + N1
    if i >= k_w2:
        return transposed_slot(i, k_w2, N1, NO)
    if i >= k_w1:
        return transposed_slot(i, k_w1, H + I, N1)
    off = k_b if i >= k_b else k_wi if i >= k_wi else 0
    n = 1 if i >= k_b else I if i >= k_wi else H
    r, j = (i - off) // n, (i - off) % n
    g = r // H
    lane = (g >> 1) * H + r % H
    return off + (g & 1) * n * 2 * H + j * 2 * H + lane


def staged(table, slot):
    """The warp form's table: entry i of ``table`` at ``slot(i)``; every
    slot taken once."""
    n = table.numel()
    perm = [slot(i) for i in range(n)]
    assert sorted(perm) == list(range(n))
    out = torch.empty_like(table)
    out[torch.tensor(perm)] = table
    return out


def shfl(v, j):
    """__shfl_sync from lane j: lane j's value on every lane, (LANES, B)."""
    return v[j].expand(LANES, -1)


LANE = torch.arange(LANES)


def fnn_forward_warp(p, layers, x):
    """FNN3::forward_warp, lanes as axis 0: x (N0, B) -> (N3, B)."""
    n0, n1, n2, n3 = layers
    o1 = LANE % n1
    acc = torch.zeros((LANES, x.shape[1]))
    for j in range(n0):
        acc = acc + p[j * n1 + o1][:, None] * x[j]
    a1 = torch.tanh(acc + p[n1 * n0 + o1][:, None])
    p = p[n1 * n0 + n1:]
    o2 = LANE % n2
    acc = torch.zeros_like(acc)
    for j in range(n1):
        acc = acc + p[j * n2 + o2][:, None] * shfl(a1, j)
    a2 = torch.tanh(acc + p[n2 * n1 + o2][:, None])
    p = p[n2 * n1 + n2:]
    o3 = LANE % n3
    acc = torch.zeros_like(acc)
    for j in range(n2):
        acc = acc + p[j * n3 + o3][:, None] * shfl(a2, j)
    a3 = acc + p[n3 * n2 + o3][:, None]
    return torch.stack([shfl(a3, o)[0] for o in range(n3)])


def lstm_forward_warp(p, I, H, N1, NO, h, c, x):
    """LSTMNet::forward_warp, lanes as axis 0: h, c (LANES, B) (lane o holds
    unit o % H), x (I, B); returns (out (NO, B), h', c')."""
    second = (LANE >= H)[:, None]
    wm, wi, b = p, p[4 * H * H:], p[4 * H * (H + I):]
    am_a = torch.zeros_like(h)
    am_b = torch.zeros_like(h)
    for j in range(H):
        hj = shfl(h, j)
        am_a = am_a + wm[j * 2 * H + LANE][:, None] * hj
        am_b = am_b + wm[(H + j) * 2 * H + LANE][:, None] * hj
    ai_a = torch.zeros_like(h)
    ai_b = torch.zeros_like(h)
    for j in range(I):
        ai_a = ai_a + wi[j * 2 * H + LANE][:, None] * x[j]
        ai_b = ai_b + wi[(I + j) * 2 * H + LANE][:, None] * x[j]
    g_a = sigmoid(am_a + ai_a + b[LANE][:, None])
    z_b = am_b + ai_b + b[2 * H + LANE][:, None]
    g_b = torch.where(second, torch.tanh(z_b), sigmoid(z_b))
    m_a, m_b = g_a[LANE ^ H], g_b[LANE ^ H]  # __shfl_xor_sync(..., H)
    g_i = torch.where(second, m_a, g_a)
    g_f = torch.where(second, m_b, g_b)
    g_o = torch.where(second, g_a, m_a)
    g_c = torch.where(second, g_b, m_b)
    c = g_i * g_c + g_f * c
    h = g_o * torch.tanh(c)
    head = p[4 * H * (H + I) + 4 * H:]
    w1, b1 = head, head[N1 * (H + I):]
    w2, b2 = b1[N1:], b1[N1 + NO * N1:]
    o1 = LANE % N1
    acc = torch.zeros_like(h)
    for j in range(H):
        acc = acc + w1[j * N1 + o1][:, None] * shfl(h, j)
    for j in range(I):
        acc = acc + w1[(H + j) * N1 + o1][:, None] * x[j]
    a1 = torch.tanh(acc + b1[o1][:, None])
    o2 = LANE % NO
    acc = torch.zeros_like(h)
    for j in range(N1):
        acc = acc + w2[j * NO + o2][:, None] * shfl(a1, j)
    v = acc + b2[o2][:, None]
    return torch.stack([shfl(v, o)[0] for o in range(NO)]), h, c


def _randomize(*buffers, seed):
    """Random values in every parameter, the biases included (``create``
    leaves them zero)."""
    rng = np.random.default_rng(seed)
    for b in buffers:
        b.copy_(torch.from_numpy((0.5 * rng.normal(size=b.shape)).astype(np.float32)))


def _inputs(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.normal(size=(n, BATCH))).astype(np.float32))


def test_fnn_lane_order_matches_the_plain_version():
    """AutoRally's 6-32-32-4 network: the warp form's lane order on its
    table equals FNN.forward_axis0_plain bit for bit."""
    layers = (6, 32, 32, 4)
    net = FNN.create(list(layers), seed=3, scale=1.0)
    _randomize(net.packed, seed=4)
    p = staged(net.packed, lambda i: fnn_warp_slot(i, layers))
    assert not torch.equal(p, net.packed)
    x = _inputs(6, 5)
    got = fnn_forward_warp(p, layers, x)
    assert torch.equal(got, net.forward_axis0_plain(x))


@pytest.mark.parametrize("I,NO", [(4, 1), (11, 2), (12, 5)])
def test_lstm_lane_order_matches_the_plain_version(I, NO):
    """The racer models' LSTMs (4 -> 16, head 20-16-1; 11 -> 16, head
    27-16-2; 12 -> 16, head 28-16-5): five steps of the warp form's lane
    order on its table, (h, c) carried per lane from a warm state, equal
    LSTM.forward_axis0_plain bit for bit in the outputs, h and c, and both
    lanes of a unit hold the same (h, c)."""
    H, N1 = 16, 16
    net = LSTM.create(I, H, [H + I, N1, NO], seed=I, scale=0.5)
    _randomize(net.packed, net.output_nn.packed, seed=I + 1)
    table = net.kernel_table()
    p = staged(table, lambda i: lstm_warp_slot(i, I, H, N1, NO))
    h, c = _inputs(H, 7, 0.3), _inputs(H, 8, 0.3)
    hw, cw = h[LANE % H], c[LANE % H]
    for step in range(5):
        x = _inputs(I, 20 + step)
        out, h, c = net.forward_axis0_plain(h, c, x)
        out_w, hw, cw = lstm_forward_warp(p, I, H, N1, NO, hw, cw, x)
        assert torch.equal(out_w, out)
        assert torch.equal(hw[:H], h) and torch.equal(hw[H:], h)
        assert torch.equal(cw[:H], c) and torch.equal(cw[H:], c)
