"""K2's stage (d)/(e) kinds beside refraction and media ids against
tracer_tpu on the CPU:

* K2's plain version lane by lane against tracer_tpu's
  bounce_reflect_pallas in TPU interpret mode in the four instances
  <kRefr, kScat, kMedia, kExtra = true>, on a glass cover over a
  Cook-Torrance target, config 6's lens in an HG medium over a
  Cook-Torrance floor, an absorbing slab beside a transparent sheet, and
  config 8b's box with a Lambertian-specular floor. The two versions
  draw from different generators, so each scene is held on lanes whose
  outcome no draw decides: refraction where it is total (lanes inside
  the glass beyond the critical angle) or index-matched, Cook-Torrance
  rows with a Beckmann alpha of 1e-7 (the half-vector is the normal to
  within 1e-6), a Lambertian-specular floor of specularity 1, and media
  whose scattering coefficient (1e-9/m) leaves every free path longer
  than the scene; attenuation, the medium ids and the epilogue's order
  are the same as the traced scenes';
* the glazed config 7 ("7g": a glass cover under config 7's target)
  through the port's plain megakernel and, its source without the spec,
  through the general path's fused K2 branch, against tracer_tpu's
  trace_streaming: every fraction within 3 combined sigma.

The CUDA kernel runs only on a GPU: tests/test_torch_gpu.py and
tests/test_torch_emulated.py hold it in the same modes against the same
plain version, with every random branch on.
"""
import jax
import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu_torch import engine
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models.bench_configs import (BENCH, bench_assembly,
                                                   bench_scene, max_rounds,
                                                   without_spec)
from test_torch_gpu import T_EPS, k2_instance, mixed_assembly
from test_torch_refraction import (_frac, cone_dirs, k2_interpret,
                                   trace_matches_jax, twins)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

SLAB = 2 * kb.TILE


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


def glass_over_ct(pkg):
    """The glazed config 7's geometry: config 7's target (Cook-Torrance,
    alpha 1e-7) and dome under a glass cover (n 1 | 1.5) at z = -1 m."""
    G, M, sc = pkg.geometry, pkg.materials, pkg.scene
    asm, _ = bench_assembly(pkg, "7g")
    asm.objects[0].surfaces[0].optics = M.bdrf_cook_torrance(1e-7, 1.2, 7.0,
                                                             0.9)
    return asm, ()


def lens_hg_ct(pkg):
    """Config 6's lens and receiver over a Cook-Torrance floor (alpha
    1e-7) at z = -1 m (mixed_assembly's "lens_hg_ct")."""
    asm = mixed_assembly(pkg, "lens_hg_ct")
    asm.objects[-1].surfaces[-1].optics = pkg.materials.bdrf_cook_torrance(
        1e-7, 1.2, 7.0, 0.9)
    return asm, ()


def slab_transparent(pkg):
    return mixed_assembly(pkg, "slab_transparent"), ()


def box_ls(pkg):
    """Config 8b's box with a Lambertian-specular floor of specularity 1
    (absorptivity 0.3) and sheets bounding a medium of scattering 1e-9/m
    (g 0.6, attenuation 0.15/m)."""
    M = pkg.materials
    asm = mixed_assembly(pkg, "box_ls")
    surfs = asm.objects[0].surfaces
    surfs[0].optics = M.lambertian_specular(0.3, 1.0, 0.0)
    for s in surfs:
        if s.name in ("m1", "m2"):
            s.optics = M.scattering_interface(1e-9, g=0.6, att_inside=0.15)
    return asm, ()


def aimed(rng, n, lo, hi, z, th_lo, th_hi, up):
    """n lanes at height z over the square [lo, hi]^2 heading up (or down)
    at th_lo-th_hi from the vertical."""
    pos = np.column_stack([rng.uniform(lo, hi, (n, 2)), np.full(n, z)])
    return pos, cone_dirs(rng, n, th_lo, th_hi, up)


def lens_mid_z(table) -> float:
    """The height halfway between the lens's faces on its axis."""
    rows = kb.pack_rows(table)
    pos = torch.tensor([[0.0, 0.0, 1.0]])
    down = torch.tensor([[0.0, 0.0, -1.0]])
    z = []
    for _ in range(2):
        t = kn.nearest_hit_ref(rows, pos, down, table.groups, T_EPS,
                               need_local=False)[0]
        pos = pos + t[:, None] * down
        z.append(float(pos[0, 2]))
    return 0.5 * (z[0] + z[1])


def mixed_lanes(scene, table, n, rng):
    """(pos, dirs, index) of n lanes of ``scene`` whose outcome draws no
    deciding number."""
    parts = []
    if scene == "glass_over_ct":
        # up onto the target from under it (above the cover), and inside
        # the cover's glass (index 1.5) onto it beyond the critical angle
        parts.append(aimed(rng, n // 2, -0.4, 0.4, -0.5, 0.0, 0.5, True)
                     + (1.0,))
        parts.append(aimed(rng, n - n // 2, -0.5, 0.5, -1.2, 0.87, 1.3,
                           True) + (1.5,))
    elif scene == "lens_hg_ct":
        # down onto the floor beside the receiver (none misses it: a miss
        # would scatter at a random point, as far as its free path), and
        # inside the lens (index 1.5, within its 2 cm centre) onto its
        # back face at least 12 degrees beyond the critical angle (the
        # face tilts up to 8 degrees there)
        parts.append(aimed(rng, n // 2, 0.35, 0.75, -0.5, 0.0, 0.4, False)
                     + (1.0,))
        parts.append(aimed(rng, n - n // 2, -0.03, 0.03, lens_mid_z(table),
                           0.95, 1.15, False) + (1.5,))
    elif scene == "slab_transparent":
        # down onto the sheet and the slab's top disc
        parts.append(aimed(rng, n, -0.9, 0.9, 1.2, 0.0, 0.6, False) + (1.0,))
    else:
        # down onto the top sheet of the medium, and from under the lower
        # one (in the ambient) onto the floor
        parts.append(aimed(rng, n // 2, -2.0, 2.0, 3.7, 0.0, 0.6, False)
                     + (1.0,))
        parts.append(aimed(rng, n - n // 2, -2.0, 2.0, 0.5, 0.0, 0.6, False)
                     + (1.0,))
    pos = np.concatenate([p for p, _, _ in parts])
    d = np.concatenate([q for _, q, _ in parts])
    ri = np.concatenate([np.full(len(p), r) for p, _, r in parts])
    return pos, d, ri


# scene builder and the K2 modes of its trace (the ambient HG medium of
# config 8, with a negligible scattering coefficient, for the lens)
MIXED_CASES = {
    "glass_over_ct": (glass_over_ct, dict(cook_torrance=True)),
    "lens_hg_ct": (lens_hg_ct, dict(cook_torrance=True, ambient_att=0.15,
                                    ambient_scat=1e-9, ambient_g=0.6)),
    "slab_transparent": (slab_transparent, dict(transparent=True)),
    "box_ls": (box_ls, dict(lam_specular=True)),
}


@pytest.mark.parametrize("scene", MIXED_CASES)
def test_k2_mixed_matches_tpu_kernel_interpret(monkeypatch, scene):
    """One tile of K2 in the instance <kRefr, kScat, kMedia, kExtra =
    true> the scene runs, against tracer_tpu's kernel: every live lane's
    sid, point, direction, energy, absorbed energy, index and medium id
    (points within 1e-5 of the scene scale, directions within 1e-5,
    energies within 1e-5 of the lane's: test_torch_scatterers.py's
    tolerances); the refractive rows total or index-matched, hit on more
    than a tenth of the lanes, the stage (d)/(e) rows on more than a
    tenth."""
    build, modes = MIXED_CASES[scene]
    table, _, jt, _ = twins(build)
    rng = np.random.default_rng(17)
    n = kb.TILE
    pos, d, ri = mixed_lanes(scene, table, n, rng)
    e = np.where(rng.uniform(size=n) < 0.05, 0.0, rng.uniform(0.5, 2.0, n))
    pos, dirs, e, ri = (torch.tensor(a, dtype=torch.float32)
                        for a in (pos, d, e, ri))
    kw = dict(bivar=False, one_sided=False, slope=False, ref_index=ri,
              **modes)
    if "volumetric" in table.features or scene == "slab_transparent":
        # the lanes start above the media's sheets, in the ambient (0)
        kw.update(medium_id=torch.zeros(n),
                  media=engine._bake_media(table, 0.0, 0.0, 0.0))
    assert k2_instance(dict(kw, media=kw.get("media"),
                            ambient_scat=kw.get("ambient_scat", 0.0),
                            backside_miss=False))[:4] == (
        True, "ambient_scat" in modes or scene == "box_ls",
        "media" in kw, True)
    got = kb.bounce_reflect(kb.pack_rows(table), 7, pos, dirs, e,
                            table.groups, T_EPS, **kw)
    want = k2_interpret(monkeypatch, jt, 7, pos, dirs, e, **kw)
    got = [a.numpy() for a in got]
    live = e.numpy() > 0
    np.testing.assert_array_equal(got[3][live], want[3][live])
    scale = 1.0 + np.abs(pos.numpy()).max(axis=1)
    dp = np.abs(got[0] - want[0]).max(axis=1)
    assert (dp[live] <= 1e-5 * scale[live]).all(), dp[live].max()
    dd = np.abs(got[1] - want[1]).max(axis=1)
    assert (dd[live] <= 1e-5).all(), dd[live].max()
    e_in = e.numpy()
    for k in (2, 4):
        assert (np.abs(got[k] - want[k])[live] <= 1e-5 * e_in[live]).all()
    for k in range(5, len(got)):
        np.testing.assert_array_equal(got[k][live], want[k][live])
    kinds = table.opt_kind.numpy()[np.maximum(got[3], 0)]
    hit = live & (got[3] >= 0)
    refr = hit & (kinds == ptt.materials.K_REFRACTIVE)
    extra = hit & (kinds != ptt.materials.K_REFRACTIVE) & (
        kinds != ptt.materials.K_ABSORBER)
    assert refr.sum() > 0.1 * n and extra.sum() > 0.1 * n
    # refraction was decided without a draw: total internal reflection
    # keeps the lane in the glass; an index-matched sheet passes it into
    # the medium beyond
    if scene in ("glass_over_ct", "lens_hg_ct"):
        assert (got[5][refr] == 1.5).all()
        assert (got[1][refr, 2] * dirs.numpy()[refr, 2] < 0.0).all()
    else:
        assert (got[6][refr] != 0.0).all()


@pytest.mark.parametrize("path", ("megakernel", "general"))
def test_glazed_config7_trace_matches_jax(monkeypatch, path):
    """The glazed config 7 at 4 slabs of 2 tiles through the port's plain
    megakernel (K2 with a per-lane index and the Cook-Torrance epilogue
    every round) or, its source without the spec, the general path's
    fused K2 branch: every fraction within 3 combined binomial sigma of
    tracer_tpu's trace_streaming, closure below 1e-5; the dome takes
    more than 0.4 of the source."""
    calls = []
    k2 = engine.bounce_reflect

    def spy(*args, **kw):
        calls.append((kw.get("ref_index") is not None,
                      bool(kw.get("cook_torrance")), kw.get("regen", False)))
        return k2(*args, **kw)
    monkeypatch.setattr(engine, "bounce_reflect", spy)
    if path == "megakernel":
        p, meta = trace_matches_jax("7g")
    else:
        # the megakernel's fractions (tracer_tpu's checked), then the
        # general path's own K2 calls
        mega, _ = trace_matches_jax("7g")
        calls.clear()
        table, meta, source_fn = bench_scene("7g", SLAB, "cpu")
        acc, em, se = trace_streaming(
            table, without_spec(source_fn), torch.Generator().manual_seed(0),
            4 * SLAB, max_rounds=max_rounds("7g", 4),
            max_path=BENCH["7g"]["max_path"])
        assert int(em) == 4 * SLAB
        assert abs(energy_closure(acc, se)) < 1e-5
        p = acc.absorbed.double().numpy() / float(se)
        n = 4 * SLAB
        q = mega[:-1]
        sig = np.sqrt(np.maximum(q * (1 - q), 1e-12) * 2.0 / n)
        assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert _frac(meta, p[:meta.row_logical.shape[0]], "dome") > 0.4
    assert calls and all(c[:2] == (True, True) for c in calls)
    assert any(c[2] for c in calls) == (path == "megakernel")
