"""K1's share of its roofline in the profiled slice: the least time of the
work the slice's rays needed (roofline.k1_bound: every traced segment's
result written and its ray read, a regenerated lane's energy, the rows
once a launch; one row test and the shade a segment, the sample a
regenerated lane) over K1's profiled device time. The segments are the
slice's emitted rays times the reference's segments a ray; all carried
segments are charged to K1, the drain's too."""
from .. import roofline
from ..kernels import kernel_time, slice_work


def read(run):
    t = kernel_time(run, "k1")
    if not t:
        return None
    emitted, segments, launches = slice_work(run, "k1")
    ms, _ = roofline.k1_bound(
        segments, segments - emitted, emitted,
        launches * 4 * roofline.ROW_WORDS * len(run.scene.rows),
        segments * roofline.row_ops(*roofline.ROW_KINDS["rect"]))
    return 100.0 * ms * 1e-3 / t
