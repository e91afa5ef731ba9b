"""The plain reference trace: every ray against every row, one bounce at a
time, in plain PyTorch in the dtype it is given (float64 for the
reference; the control runs the same code in bfloat16).

Each source ray deposits its energy on rows (absorbed), on the sky
(escaped) or on the budgets (lost: under ``min_energy`` after a hit, or
alive after ``max_hits`` hits). ``trace`` returns per-ray sums and sums
of squares of those deposits, as fractions of a ray's energy, for every
category: each row, escaped, lost and each coarse bin of the receiver's
flux map. A mean and its standard error follow from them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .scene import Scene

THETA_DISC = 4.65e-3     # Buie's solar-disc half angle [rad]
THETA_AUREOLE = 43.6e-3  # where Buie's aureole ends [rad]


@dataclasses.dataclass
class Stats:
    """Per-category sums over ``n`` source rays of each ray's deposit (a
    fraction of its energy) and of its square; ``segments`` counts the
    ray segments traced (a ray's last, which escapes, included)."""
    names: list
    n: int
    s1: np.ndarray
    s2: np.ndarray
    segments: int

    def mean(self) -> np.ndarray:
        return self.s1 / self.n

    def var(self) -> np.ndarray:
        """Variance of one ray's deposit."""
        m = self.mean()
        return np.maximum(self.s2 / self.n - m * m, 0.0) * self.n / max(
            self.n - 1, 1)


def buie_table(csr: float, n: int = 200_001):
    """(u, theta) of the inverse CDF of Buie's sunshape: the disc profile
    cos(0.326 t) / cos(0.308 t) weighted by cos(theta) sin(theta), then
    the aureole exp(kappa) t^gamma weighted by theta (t in mrad), to
    THETA_AUREOLE."""
    theta = np.linspace(0.0, THETA_AUREOLE, n)
    t = theta * 1e3
    disc = theta <= THETA_DISC
    dens = np.where(disc, np.cos(0.326 * t) / np.cos(0.308 * np.minimum(
        t, THETA_DISC * 1e3)) * np.cos(theta) * np.sin(theta), 0.0)
    if csr > 0.0:
        kappa = 0.9 * math.log(13.5 * csr) * csr ** -0.3
        gamma = 2.2 * math.log(0.52 * csr) * csr ** 0.43 - 0.1
        aur = math.exp(kappa) * np.maximum(t, 1e-12) ** gamma * theta
        dens = np.where(disc, dens, aur)
    # the disc's edge is a jump: integrate each side of it apart
    cdf = np.concatenate([[0.0], np.cumsum(0.5 * (dens[1:] + dens[:-1])
                                           * np.diff(theta))])
    edge = int(np.searchsorted(theta, THETA_DISC, side="right"))
    if csr > 0.0 and edge < n:
        # the trapezoid across the edge mixed the two profiles
        step = theta[edge] - theta[edge - 1]
        mixed = 0.5 * (dens[edge] + dens[edge - 1]) * step
        split = (dens[edge - 1] * (THETA_DISC - theta[edge - 1])
                 + dens[edge] * (theta[edge] - THETA_DISC))
        cdf[edge:] += split - mixed
    return cdf / cdf[-1], theta


def sample_source(scene: Scene, n: int, gen, dtype, device):
    """n rays of the scene's disk source: (pos, dir), each (n, 3)."""
    src = scene.source
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.rand(n, generator=gen, **f64)
    phi = torch.rand(n, generator=gen, **f64) * (2.0 * math.pi)
    r = src.radius * torch.sqrt(u)
    frame = torch.as_tensor(_frame_of(src.direction), **f64)
    pos = (torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                        torch.zeros_like(r)], 1) @ frame.T
           + torch.as_tensor(src.centre, **f64))
    v = torch.rand(n, generator=gen, **f64)
    psi = torch.rand(n, generator=gen, **f64) * (2.0 * math.pi)
    if src.sunshape == "pillbox":
        sin_t = math.sin(src.half_angle) * torch.sqrt(v)
        theta = torch.asin(sin_t)
    else:
        cdf, grid = buie_table(src.csr)
        theta = _interp(v, torch.as_tensor(cdf, **f64),
                        torch.as_tensor(grid, **f64))
    local = torch.stack([torch.sin(theta) * torch.cos(psi),
                         torch.sin(theta) * torch.sin(psi),
                         torch.cos(theta)], 1)
    return pos.to(dtype), (local @ frame.T).to(dtype)


def _frame_of(d) -> np.ndarray:
    d = np.asarray(d, dtype=float)
    a = np.array([1.0, 0.0, 0.0]) if abs(d[0]) < 0.9 else np.array(
        [0.0, 1.0, 0.0])
    x = np.cross(a, d)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(d, x), d], axis=1)


def _interp(x, xp, fp):
    i = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0,
                    xp.shape[0] - 2)
    x0, x1 = xp[i], xp[i + 1]
    w = torch.where(x1 > x0, (x - x0) / torch.where(x1 > x0, x1 - x0, 1.0),
                    0.0)
    return fp[i] + w * (fp[i + 1] - fp[i])


class _Rows:
    """The scene's rows as tensors: world-to-local rotations, origins,
    sizes and optics, in ``dtype``."""

    def __init__(self, scene: Scene, dtype, device):
        kw = dict(dtype=dtype, device=device)
        self.n = len(scene.rows)
        frames = np.stack([r.frame for r in scene.rows])
        self.rot = torch.as_tensor(frames[:, :3, :3], **kw)    # columns
        self.org = torch.as_tensor(frames[:, :3, 3], **kw)
        self.rect = [i for i, r in enumerate(scene.rows) if r.kind == "rect"]
        self.parab = [i for i, r in enumerate(scene.rows)
                      if r.kind == "parab"]
        ri = torch.as_tensor(self.rect, device=device, dtype=torch.long)
        self.rect_idx = ri
        # rect rows: planes z_local = 0 as dot products with their axes
        self.axes = self.rot[ri].transpose(1, 2)               # (R, 3, 3)
        self.offs = torch.einsum("rij,rj->ri", self.axes, self.org[ri])
        self.half = torch.as_tensor(
            [[r.size[0] / 2.0, r.size[1] / 2.0] for r in scene.rows
             if r.kind == "rect"], **kw).reshape(-1, 2)
        self.absorb = torch.as_tensor([r.absorptivity for r in scene.rows],
                                      **kw)
        self.sigma = torch.as_tensor([r.slope_sigma for r in scene.rows],
                                     **kw)
        self.one_sided = torch.as_tensor([r.one_sided for r in scene.rows],
                                         device=device)
        self.parab_size = [scene.rows[i].size for i in self.parab]


def _nearest(rows: _Rows, pos, dirs, eps):
    """(t, row) of each ray's nearest hit beyond ``eps`` (inf, -1 on a
    miss)."""
    n = pos.shape[0]
    inf = torch.full((n,), math.inf, dtype=pos.dtype, device=pos.device)
    best_t, best_r = inf, torch.full((n,), -1, dtype=torch.long,
                                     device=pos.device)
    if rows.rect:
        ax = rows.axes.reshape(-1, 3)                          # (3R, 3)
        pl = (pos @ ax.T).view(n, -1, 3) - rows.offs           # (n, R, 3)
        dl = (dirs @ ax.T).view(n, -1, 3)
        dz = dl[..., 2]
        safe = torch.where(dz == 0.0, torch.ones_like(dz), dz)
        t = torch.where(dz == 0.0, math.inf, -pl[..., 2] / safe)
        x = pl[..., 0] + t * dl[..., 0]
        y = pl[..., 1] + t * dl[..., 1]
        ok = ((t > eps[:, None]) & (x.abs() <= rows.half[:, 0])
              & (y.abs() <= rows.half[:, 1]))
        t = torch.where(ok, t, math.inf)
        t_min, k = t.min(1)
        better = t_min < best_t
        best_t = torch.where(better, t_min, best_t)
        best_r = torch.where(better, rows.rect_idx[k], best_r)
    for j, (a, z_max) in zip(rows.parab, rows.parab_size):
        rot, org = rows.rot[j], rows.org[j]
        pl, dl = (pos - org) @ rot, dirs @ rot
        qa = a * (dl[:, 0] ** 2 + dl[:, 1] ** 2)
        qb = 2.0 * a * (pl[:, 0] * dl[:, 0] + pl[:, 1] * dl[:, 1]) - dl[:, 2]
        qc = a * (pl[:, 0] ** 2 + pl[:, 1] ** 2) - pl[:, 2]
        disc = qb * qb - 4.0 * qa * qc
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        lin = qa.abs() < 1e-300
        sa = torch.where(lin, torch.ones_like(qa), qa)
        sb = torch.where(qb == 0.0, torch.ones_like(qb), qb)
        cands = (torch.where(lin, -qc / sb, (-qb - root) / (2.0 * sa)),
                 torch.where(lin, math.inf, (-qb + root) / (2.0 * sa)))
        t_j = torch.full_like(best_t, math.inf)
        for tc in cands:
            z = pl[:, 2] + tc * dl[:, 2]
            ok = ((disc >= 0.0) | lin) & (tc > eps) & (z >= 0.0) & (
                z <= z_max)
            t_j = torch.minimum(t_j, torch.where(ok, tc, math.inf))
        better = t_j < best_t
        best_t = torch.where(better, t_j, best_t)
        best_r = torch.where(better, torch.full_like(best_r, j), best_r)
    return best_t, best_r


def _normals(rows: _Rows, scene: Scene, row, hit):
    """Unit geometric normals (world) of each ray's row at ``hit``."""
    rot = rows.rot[row]
    nrm = rot[:, :, 2].clone()
    for j, (a, _) in zip(rows.parab, rows.parab_size):
        on = row == j
        if bool(on.any()):
            local = (hit[on] - rows.org[j]) @ rows.rot[j]
            g = torch.stack([2.0 * a * local[:, 0], 2.0 * a * local[:, 1],
                             -torch.ones_like(local[:, 0])], 1)
            nrm[on] = g @ rows.rot[j].T
    return nrm / torch.linalg.norm(nrm, dim=1, keepdim=True)


def _perturb(nrm, sigma, gen):
    """Bivariate slope error: the normal tilted by tan(sigma g1) and
    tan(sigma g2) along two tangents (g1, g2 standard normal)."""
    g = torch.randn((nrm.shape[0], 2), generator=gen, dtype=torch.float64,
                    device=nrm.device).to(nrm.dtype)
    tx = torch.tan(sigma * g[:, 0])
    ty = torch.tan(sigma * g[:, 1])
    a = torch.zeros_like(nrm)
    use_x = nrm[:, 0].abs() < 0.9
    a[:, 0] = torch.where(use_x, 1.0, 0.0)
    a[:, 1] = torch.where(use_x, 0.0, 1.0)
    t1 = torch.linalg.cross(a, nrm)
    t1 = t1 / torch.linalg.norm(t1, dim=1, keepdim=True)
    t2 = torch.linalg.cross(nrm, t1)
    out = tx[:, None] * t1 + ty[:, None] * t2 + nrm
    return out / torch.linalg.norm(out, dim=1, keepdim=True)


def categories(scene: Scene, coarse: int):
    """Names of the compared categories: every row, escaped, lost, then
    the receiver's coarse flux bins (row-major, ``coarse`` a side)."""
    names = [r.name for r in scene.rows] + ["escaped", "lost"]
    names += [f"flux_{i}_{j}" for i in range(coarse) for j in range(coarse)]
    return names


def trace(scene: Scene, n_rays: int, seed: int, *, max_hits: int,
          min_energy: float, e_ray: float, flux_bins: int, coarse: int,
          dtype=torch.float64, device="cpu", chunk: int = 1 << 18,
          eps: float = 1e-7) -> Stats:
    """Trace ``n_rays`` source rays of energy ``e_ray`` each in chunks.
    A ray may hit at most ``max_hits`` rows; what is alive after that is
    lost. The receiver's map has ``flux_bins`` bins a side over its local
    (x, y), summed into ``coarse`` x ``coarse`` blocks."""
    rows = _Rows(scene, dtype, device)
    names = categories(scene, coarse)
    n_cat = len(names)
    esc, lost, flux0 = rows.n, rows.n + 1, rows.n + 2
    rec = next(i for i, r in enumerate(scene.rows) if r.name == scene.receiver)
    rec_rot, rec_org = rows.rot[rec], rows.org[rec]
    rec_half = rows.half[rows.rect.index(rec)]
    per_block = flux_bins // coarse
    gen = torch.Generator(device=device).manual_seed(seed)
    s1 = torch.zeros(n_cat, dtype=torch.float64, device=device)
    s2 = torch.zeros(n_cat, dtype=torch.float64, device=device)
    segments = 0
    done = 0
    while done < n_rays:
        m = min(chunk, n_rays - done)
        pos, dirs = sample_source(scene, m, gen, dtype, device)
        e = torch.full((m,), e_ray, dtype=dtype, device=device)
        ray = torch.arange(m, device=device)
        dep = torch.zeros(m * n_cat, dtype=torch.float64, device=device)

        def deposit(idx, cat, amount):
            dep.index_add_(0, idx * n_cat + cat, amount.to(torch.float64))
        for hit_no in range(max_hits):
            if ray.numel() == 0:
                break
            segments += ray.numel()
            scale = 1.0 + pos.abs().amax(1)
            t, row = _nearest(rows, pos, dirs, eps * scale)
            miss = row < 0
            deposit(ray[miss], torch.full_like(ray[miss], esc), e[miss])
            keep = ~miss
            ray, pos, dirs, e, t, row = (x[keep] for x in
                                         (ray, pos, dirs, e, t, row))
            hit = pos + t[:, None] * dirs
            geo = _normals(rows, scene, row, hit)
            back = (dirs * geo).sum(1) > 0.0
            facing = torch.where(back[:, None], -geo, geo)
            sig = rows.sigma[row]
            nrm = torch.where((sig > 0.0)[:, None],
                              _perturb(facing, sig, gen), facing)
            refl = dirs - 2.0 * (dirs * nrm).sum(1, keepdim=True) * nrm
            kill = rows.one_sided[row] & back
            absorbed = torch.where(kill, e, e * rows.absorb[row])
            e_out = e - absorbed
            deposit(ray, row, absorbed)
            on_rec = row == rec
            if bool(on_rec.any()):
                local = (hit[on_rec] - rec_org) @ rec_rot
                iu = torch.floor((local[:, 0] + rec_half[0])
                                 * (flux_bins / (2.0 * rec_half[0])))
                iv = torch.floor((local[:, 1] + rec_half[1])
                                 * (flux_bins / (2.0 * rec_half[1])))
                iu = torch.clamp(iu, 0, flux_bins - 1).long() // per_block
                iv = torch.clamp(iv, 0, flux_bins - 1).long() // per_block
                deposit(ray[on_rec], flux0 + iu * coarse + iv,
                        absorbed[on_rec])
            low = e_out <= min_energy
            deposit(ray[low], torch.full_like(ray[low], lost), e_out[low])
            keep = ~low
            ray, pos, dirs, e = (ray[keep], hit[keep], refl[keep],
                                 e_out[keep])
            if hit_no + 1 == max_hits:
                # a ray alive after its last allowed hit is lost
                deposit(ray, torch.full_like(ray, lost), e)
        x = dep.view(m, n_cat) / e_ray
        s1 += x.sum(0)
        s2 += (x * x).sum(0)
        done += m
    return Stats(names, n_rays, s1.cpu().numpy(), s2.cpu().numpy(),
                 segments)
