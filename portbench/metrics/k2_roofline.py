"""K2's share of its roofline in the profiled slice: every traced segment
against every row of the scene (K2's brute force), shaded, its result
written and its ray read (a regenerated lane's energy only), the rows once
a launch (roofline.k2_bound), over K2's profiled device time. The
segments are the slice's emitted rays times the reference's segments a
ray."""
from .. import roofline
from ..kernels import kernel_time, slice_work


def read(run):
    t = kernel_time(run, "k2")
    if not t:
        return None
    emitted, segments, launches = slice_work(run, "k2")
    ms, _ = roofline.k2_bound(
        segments, emitted,
        launches * roofline.ROW_WORDS * len(run.scene.rows),
        roofline.scene_row_ops(r.kind for r in run.scene.rows))
    return 100.0 * ms * 1e-3 / t
