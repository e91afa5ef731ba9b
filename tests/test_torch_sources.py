"""The port's Buie source against tracer_tpu's (exact spec, statistical
angles) and its Philox generator against the Random123 known answers."""
import jax
import numpy as np
import pytest
import torch

from tracer_tpu import sources as jsrc
from tracer_tpu_torch import sources as psrc
from tracer_tpu_torch.kernels.philox import philox4x32, uniforms

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

CENTER = np.array([1.0, 80.0, 300.0])
DIRECTION = np.array([0.0, -0.5, -0.8660254037844386])


@pytest.mark.parametrize("csr", (0.0, 0.02, 0.1))
def test_buie_pallas_spec_equal(csr):
    a = psrc.buie_sunshape_pallas_spec(49152, CENTER, DIRECTION, 120.0, csr,
                                       1000.0)
    b = jsrc.buie_sunshape_pallas_spec(49152, CENTER, DIRECTION, 120.0, csr,
                                       1000.0)
    assert len(a) == 17
    assert a == b


def _polar(dirs, axis):
    """Angle to the axis from the cross product: float32 directions hold
    milliradian angles in their transverse components, not in the dot
    product's distance from 1."""
    return np.arctan2(np.linalg.norm(np.cross(dirs, axis), axis=1),
                      dirs @ axis)


def test_buie_polar_angles_match_jax():
    """Histogram of the angle to the source axis, 200k rays each side:
    every bin agrees within 3 sigma of the two-sample count difference."""
    n = 200_000
    pb = psrc.buie_sunshape(torch.Generator().manual_seed(0), n, CENTER,
                            DIRECTION, 120.0, 0.02, flux=1000.0,
                            device="cpu")
    jb = jsrc.buie_sunshape(jax.random.PRNGKey(0), n, CENTER, DIRECTION,
                            120.0, 0.02, flux=1000.0)
    axis = DIRECTION / np.linalg.norm(DIRECTION)
    tp = _polar(pb.dir.double().numpy(), axis)
    tj = _polar(np.asarray(jb.dir, dtype=np.float64), axis)
    edges = np.concatenate([np.linspace(0.0, 4.65e-3, 11),
                            [6e-3, 1e-2, 2e-2, 4.4e-2]])
    hp, _ = np.histogram(tp, edges)
    hj, _ = np.histogram(tj, edges)
    assert hp.sum() > 0.99 * n and hj.sum() > 0.99 * n
    assert (np.abs(hp - hj) <= 3.0 * np.sqrt(hp + hj + 1.0)).all(), (hp, hj)
    # energies and the disk footprint agree exactly / statistically
    np.testing.assert_allclose(pb.energy[0].item(), float(jb.energy[0]),
                               rtol=1e-6)
    rp = np.linalg.norm(pb.pos.double().numpy() - CENTER, axis=1)
    rj = np.linalg.norm(np.asarray(jb.pos, dtype=np.float64) - CENTER, axis=1)
    assert abs(rp.mean() - rj.mean()) < 3.0 * np.sqrt(2.0 / n) * rj.std()


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's philox4x32-10 known-answer vectors."""
    got = philox4x32(*ctr, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_uniforms_chi_square():
    """Uniforms of 2^17 lanes x 4 words in 64 bins: chi-square with 63
    degrees of freedom within 5 standard deviations of its mean, and every
    value in (0, 1]."""
    lane = torch.arange(1 << 17)
    u = torch.cat(uniforms(12345, 7, lane, 1)).double().numpy()
    assert u.min() > 0.0 and u.max() <= 1.0
    h, _ = np.histogram(u, 64, (0.0, 1.0))
    expect = len(u) / 64
    chi2 = ((h - expect) ** 2 / expect).sum()
    assert abs(chi2 - 63) < 5 * np.sqrt(2 * 63), chi2


def test_philox_streams_differ():
    lane = torch.arange(4096)
    a = uniforms(1, 0, lane, 0)[0]
    b = uniforms(1, 1, lane, 0)[0]
    c = uniforms(2, 0, lane, 0)[0]
    assert not torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 0.05
