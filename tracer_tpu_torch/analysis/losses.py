"""Per-heliostat blocking / shading / spillage attribution for tower
fields, from the engine's per-bounce records (the port of
tracer_tpu/analysis/losses.py: host NumPy over the records that
TracerEngine.ray_tracer copies to the host each bounce).

Replaces the reference's genealogy walk over RayTree bundles
(examples/Sandia_NSTTF_field example.py:229-301, which matches bounce-1
vertices against per-heliostat accountant hits in nested Python loops):
the fixed-slab BounceRecord design makes slot i of bounce b the parent of
slot i of bounce b+1, so the whole attribution is a handful of vectorized
masks over the first two records.

Definitions (bounce-1 attribution horizon, as in the reference):
  incoming[h]  energy arriving on heliostat h directly from the source
  shading[h]   flux * projected_area[h] - incoming[h] (energy the mirror
               would collect if nothing upstream shaded it)
  mirror[h]    energy absorbed by the mirror surface itself (reflectivity)
  blocked[h]   reflected energy whose NEXT hit is another heliostat
  spilled[h]   reflected energy that escapes the scene entirely
  delivered[h] reflected energy arriving on the receiver

Exact audits (float tolerance):
  source  = sum_h incoming + direct_receiver + escaped_at_bounce0
  incoming[h] = mirror[h] + blocked[h] + spilled[h] + delivered[h]
               (+ a min_energy cull residue, returned as other[h])
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x, dtype=None) -> np.ndarray:
    """A record field (a tensor on either device, or an array) as a host
    array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def projected_areas(normals: np.ndarray, sun_vec: np.ndarray,
                    area: float) -> np.ndarray:
    """Sun-projected mirror areas: area * max(n . sun, 0) per heliostat
    (the reference's hstat_proj_areas)."""
    cos = np.asarray(normals, dtype=float) @ np.asarray(sun_vec, dtype=float)
    return float(area) * np.maximum(cos, 0.0)


def field_losses(result, heliostat_prefix: str = "heliostat_",
                 receiver_name: str = "receiver", flux: float = 1000.0,
                 proj_areas=None) -> dict:
    """Attribute first-bounce losses per heliostat from a TraceResult
    traced with records (TracerEngine.ray_tracer, record=True).

    Returns a dict of (n_heliostats,) arrays: incoming, shading, mirror,
    blocked, spilled, delivered, other — plus scalars direct_receiver,
    escaped_source, source, and the audit residues audit_source /
    audit_per_heliostat (both ~0).
    """
    meta = result.meta
    if meta is None or len(result.records) < 1:
        raise ValueError("field_losses needs a SceneMeta and >= 1 records")
    names = meta.names
    helio_ids = [i for i, nm in enumerate(names)
                 if nm.startswith(heliostat_prefix)]
    # order by the numeric suffix so outputs align with field positions
    helio_ids.sort(key=lambda i: int(names[i][len(heliostat_prefix):]))
    rec_id = meta.index_of(receiver_name)
    nh = len(helio_ids)
    lid_of_helio = {lid: k for k, lid in enumerate(helio_ids)}

    row_log = np.asarray(meta.row_logical)
    # per-row: heliostat index (or -1), receiver flag
    row_h = np.array([lid_of_helio.get(int(l), -1) for l in row_log])
    row_rec = row_log == rec_id

    rec0 = result.records[0]
    sid0 = _np(rec0.sid)
    live0 = _np(rec0.alive_in)
    e_in0 = _np(rec0.e_in, float)
    abs0 = _np(rec0.absorbed, float)
    e_out0 = _np(rec0.e_out, float)

    hit0 = live0 & (sid0 >= 0)
    h_of_slot = np.where(hit0, row_h[np.maximum(sid0, 0)], -1)
    on_helio0 = h_of_slot >= 0
    on_rec0 = hit0 & row_rec[np.maximum(sid0, 0)]

    def per_h(values, mask):
        out = np.zeros(nh)
        np.add.at(out, h_of_slot[mask], values[mask])
        return out

    incoming = per_h(e_in0, on_helio0)
    mirror = per_h(abs0, on_helio0)

    blocked = np.zeros(nh)
    spilled = np.zeros(nh)
    delivered = np.zeros(nh)
    if len(result.records) > 1:
        rec1 = result.records[1]
        sid1 = _np(rec1.sid)
        live1 = _np(rec1.alive_in)
        e_in1 = _np(rec1.e_in, float)
        child_hit = live1 & (sid1 >= 0)
        child_helio = child_hit & (row_h[np.maximum(sid1, 0)] >= 0)
        child_rec = child_hit & row_rec[np.maximum(sid1, 0)]
        child_escaped = live1 & (sid1 < 0)
        blocked = per_h(e_in1, on_helio0 & child_helio)
        delivered = per_h(e_in1, on_helio0 & child_rec)
        spilled = per_h(e_out0, on_helio0 & child_escaped)
        # continuing rays culled by min_energy between the bounces
        other = per_h(e_out0, on_helio0 & ~live1)
    else:
        other = per_h(e_out0, on_helio0)

    direct_receiver = float(e_in0[on_rec0].sum())
    # escaped source energy: slots that carried a live ray but hit nothing
    src_e = _np(result.source.energy, float)
    esc_mask = live0 & (sid0 < 0)
    escaped_source = float(src_e[esc_mask].sum())
    source = float(src_e.sum())

    audit_source = source - (incoming.sum() + direct_receiver
                             + escaped_source)
    audit_per_h = incoming - (mirror + blocked + spilled + delivered + other)

    out = dict(incoming=incoming, mirror=mirror, blocked=blocked,
               spilled=spilled, delivered=delivered, other=other,
               direct_receiver=direct_receiver,
               escaped_source=escaped_source, source=source,
               audit_source=audit_source, audit_per_heliostat=audit_per_h)
    if proj_areas is not None:
        out["shading"] = flux * np.asarray(proj_areas, dtype=float) - incoming
    return out
