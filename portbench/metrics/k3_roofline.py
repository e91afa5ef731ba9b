"""K3's share of its roofline in the profiled slice: every live segment's
ray read, its results written and its test of every row of the scene
(roofline.k3_bound), over K3's profiled device time. The segments are the
slice's source rays times the reference's segments a ray; K3 also
traces the dead lanes of a bundle, which count as no work."""
from .. import roofline
from ..kernels import kernel_time, slice_work


def read(run):
    t = kernel_time(run, "k3")
    if not t:
        return None
    _, segments, _ = slice_work(run, "k3")
    ms, _ = roofline.k3_bound(
        segments, roofline.scene_row_ops(r.kind for r in run.scene.rows))
    return 100.0 * ms * 1e-3 / t
