"""The port's counter-based normals (ops/philox.py, the plain version of
csrc/philox.cuh): Philox4x32-10 against the Random123 known-answer vectors,
every draw a pure function of (seed, sample, step, channel, stream), and the
statistics battery of the JAX package's hardware-PRNG check."""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch.ops import philox

# Random123's known-answer vectors for philox4x32-10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    got = philox.philox4x32(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_philox_vectorised_matches_scalar_calls():
    ctr = torch.tensor([[0, 1, 2, 0xFFFFFFFF], [7, 0x243F6A88, 5, 3]])
    batch = philox.philox4x32(tuple(ctr.T), (0xA4093822, 0x299F31D0))
    for i in range(ctr.shape[0]):
        one = philox.philox4x32(tuple(int(c) for c in ctr[i]), (0xA4093822, 0x299F31D0))
        assert [int(w[i]) for w in batch] == [int(w) for w in one]


@pytest.mark.parametrize("C", [2, 3])
def test_draw_is_a_pure_function_of_its_indices(C):
    """Any slice of samples, drawn in any order, gives the same values."""
    seed = torch.tensor(12345, dtype=torch.int32)
    K, T = 96, 7
    whole = philox.normals(seed, K, T, C, streams=2)
    chunks = [(64, 32), (0, 40), (40, 24)]  # out of order, ragged
    for k0, n in chunks:
        part = philox.normals(seed, n, T, C, streams=2, k0=k0)
        assert torch.equal(part, whole[:, k0:k0 + n])
    # stream 0 does not depend on whether stream 1 is drawn
    assert torch.equal(philox.normals(seed, K, T, C)[0], whole[0])
    # a horizon prefix is the same draw
    assert torch.equal(philox.normals(seed, K, 3, C)[0], whole[0, :, :3])
    # an int seed is the same key as the int32 tensor
    assert torch.equal(philox.normals(12345, K, T, C)[0], whole[0])


def test_draw_follows_the_documented_mapping():
    """Channel 2p of (k, t) is r cos(theta) of the pair (w0, w1) of
    counter (k, t, p, 0) under key (seed, 0); 2p + 1 is r sin(theta);
    stream 1 takes (w2, w3)."""
    seed, k, t, p = 99, 5, 3, 1
    w = [int(x) for x in philox.philox4x32((k, t, p, 0), (seed, 0))]
    z = philox.normals(seed, k + 1, t + 1, 4, streams=2).numpy()

    def box_muller(a, b):
        u1 = (np.float32(a >> 8) + np.float32(0.5)) * np.float32(2.0 ** -24)
        u2 = np.float32(b >> 8) * np.float32(2.0 ** -24)
        r = np.sqrt(-2.0 * np.log(np.float64(u1)))
        th = 2 * np.pi * np.float64(u2)
        return r * np.cos(th), r * np.sin(th)

    for s in (0, 1):
        want = box_muller(w[2 * s], w[2 * s + 1])
        np.testing.assert_allclose(z[s, k, t, 2 * p: 2 * p + 2], want, rtol=2e-6,
                                   atol=2e-6)


def test_statistics_battery_on_the_plain_draw():
    """scripts/tpu_selfcheck.py:86-118 on K=4096, T=64 plain draws."""
    z = philox.normals(torch.tensor(99, dtype=torch.int32), 4096, 64, 2)[0]
    stats = philox.normal_battery(z[1:])
    assert not philox.normal_battery_failures(stats), stats


def test_nln_moments_on_the_plain_draw():
    s = 0.4
    z = philox.normals(77, 4096, 32, 2, streams=2)
    eps = z[0] * torch.exp(s * z[1])
    m = philox.nln_moments(eps, s)
    assert not philox.nln_moment_failures(m), m
