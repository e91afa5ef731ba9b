"""The yardstick of the kernels' roofline shares, frozen here: the card's
peaks, the float32 operations each kind of work costs, and the bytes and
operations of a K1, K2 or K3 call, counted from lanes, rays and the
scene's rows (copied from chip_smoke.py's ``bound``, ``row_ops``,
``k1_bound``, ``k2_bound`` and ``k3_bound``, reduced to the cases the
cells run).

A call's least time is the larger of its bytes over the card's memory
rate and its operations over its float32 rate.
"""
from __future__ import annotations

# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bytes per second and
# float32 operations per second outside the tensor cores, at 700 W
H100_BYTES_S = 3.35e12
H100_F32_S = 67e12

# float32 operations, counted from the kernels' source: one lane against
# one row by quadric class (transform 33, then the class's solve and the
# self-hit guard), an aperture test by kind (geometry.AP_* codes), a
# shaded lane (reflect, bivariate slope error, one-sided kill) and a
# regenerated lane (its source sample). Comparisons and selects count;
# Philox's integer rounds do not.
ROW_OPS = {"flat": 48, "parab": 93, "sphere": 90, "quadric": 133}
AP_OPS = {0: 0, 1: 4, 2: 5, 3: 2, 4: 20, 5: 1, 6: 6, 7: 15, 8: 6, 9: 5,
          10: 5, 11: 8, 12: 4, 13: 15}
SHADE_OPS = 130
REGEN_OPS = 100

# the scene description's row kinds: (quadric class, aperture kinds)
ROW_KINDS = {"rect": ("flat", (1,)), "parab": ("parab", (3,))}

ROW_WORDS = 36        # float32 words of one row: frame, optics, aperture
RAY_IN_B = 28         # a ray read: position, direction, energy
RESULT_B = 36         # a lane's results: position, direction, energy,
#                       row id, absorbed energy
REGEN_IN_B = 4        # a regenerated lane reads only its energy
K3_IN_B = 24          # K3 reads position and direction
K3_OUT_B = 52         # distance, row, normal, local point, up, kind,
#                       flags, p0, p1


def row_ops(tag: str, sig) -> int:
    """Operations of one lane against one row (curved classes test their
    apertures at both roots)."""
    return ROW_OPS[tag] + (1 if tag == "flat" else 2) * sum(
        AP_OPS[k] for k in sig)


def scene_row_ops(kinds) -> int:
    """Operations of one lane against every row of a scene (its rows'
    kinds, as the reference scene lists them)."""
    return sum(row_ops(*ROW_KINDS[k]) for k in kinds)


def bound(nbytes: float, nops: float):
    """(ms, what sets it): the larger of the bytes over the card's memory
    rate and the float32 operations over its peak rate."""
    t_b = nbytes / H100_BYTES_S * 1e3
    t_o = nops / H100_F32_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def k1_bound(lanes: int, carried: int, regen: int, table_bytes: int,
             row_tests_ops: float):
    """K1 over ``lanes`` result lanes, ``carried`` of them reading their
    ray in and ``regen`` regenerated: each result written once, each ray
    read once, the tables once; the row tests, the shade of every traced
    lane and the sample of every regenerated one."""
    return bound(RESULT_B * lanes + RAY_IN_B * carried + REGEN_IN_B * regen
                 + table_bytes,
                 row_tests_ops + (carried + regen) * SHADE_OPS
                 + regen * REGEN_OPS)


def k2_bound(lanes: int, regen: int, row_words: int, lane_row_ops: int):
    """K2, brute force: every lane against every row (``lane_row_ops``
    each) and shaded; a regenerated lane reads its energy only."""
    return bound(RESULT_B * lanes + RAY_IN_B * (lanes - regen)
                 + REGEN_IN_B * regen + 4 * row_words,
                 lanes * (lane_row_ops + SHADE_OPS) + regen * REGEN_OPS)


def k3_bound(lanes: int, lane_row_ops: int):
    """K3: each lane's ray read once, its results written once, and its
    test of every row."""
    return bound(lanes * (K3_IN_B + K3_OUT_B), lanes * lane_row_ops)
