"""tracer_tpu_torch: the PyTorch / CUDA port of tracer_tpu.

The slices that run end to end:

* the NSTTF heliostat-field trace: scene build (scene, models.nsttf),
  per-tile relevancy culling (culling), the culled streaming trace
  (engine.trace_streaming) on two hand-written CUDA kernels for Hopper
  (kernels/csrc/bounce.cu), and the receiver flux map
  (analysis.device_fluxmap);
* the TAU MiniDish (models.tau_minidish), and any scene of any optics
  kind, through the host-stepped engine.TracerEngine.ray_tracer, with
  per-bounce records and energy splitting that grows the bundle, and
  engine.trace_fused, on the nearest-hit kernel (kernels/csrc/nearest.cu),
  the volumetric media step and the shade pass (kernels/shade.py); the
  host flux map over the records (analysis.fluxmap);
* bench configurations 1-3 (the MiniDish, a slope-error dish over a
  Lambertian absorber, a spectral mirror in an attenuating medium)
  through the plain streaming megakernel, engine.trace_streaming without
  culling, on the brute-force bounce kernel with in-kernel regeneration
  (kernels/csrc/bounce.cu);
* the Kd accelerator (accel.KdTree, ray_tracer(accel=...)) and
  polychromatic bundles (RayBundle.with_spectra) on the host-stepped
  ray_tracer, with trace_tree.RayTree over its records;
* cavity receivers (bench configuration 5): MC view factors
  (analysis.view_factors, every sample's nearest hit on the nearest-hit
  kernel), the radiosity solve and its autograd twin (analysis.radiosity)
  and the 2N cavity model (models.two_n_cavity);
* differentiable tracing (diff.trace_diff, bench configurations 9 and 9b)
  under torch autograd, each winner on the nearest-hit kernel under
  no_grad in scenes of 48 rows or more; the field analyses: annual
  efficiency sweeps (analysis.annual), per-heliostat losses
  (analysis.losses) and the Welford estimator (analysis.estimator);
* the model library: the high-flux solar simulator
  (models.solar_simulator, lamps drawn on the device), the PETAL and SG4
  dishes, triangulated meshes and STL files (models.triangulated_surface,
  stl_utils), each traced on the nearest-hit kernel, with device flux
  maps of every binned kind and of multi-row surfaces; and the
  utilities: samplers (sampling), vector helpers (vector_utils), results
  and ray-source files (io_utils), the reference's optics names (compat)
  and a matplotlib renderer (viz.render);
* float64 traces on every path, on either device (the float64 oracle's
  nearest hits and the unfused shade; the kernels are float32), and the
  bundled n,k database (optical_constants.from_sopra, data/nk);
* multi-device tracing over torch.distributed (parallel): trace_sharded
  and multi_ray_sim (TracerEngineMP) on the nearest-hit kernel, and
  trace_streaming_sharded, plain or culled, each rank on its block range
  of a mesh-targeted culling (culling.build_block_culling(mesh_devices=D),
  mesh_segment_shards' row-shard segments);
* the span recorder (telemetry): off by default, on it records the
  entry calls, the round loops' launches, bookkeeping and waits, the
  drains, the all-reduce and the scene build as spans in memory on the
  profiler's host clock.

Entry points put their tensors on the GPU (device.default_device) and
raise without one unless given ``device="cpu"``. On CPU tensors every
kernel runs its plain PyTorch version. The package imports torch and
never jax; tracer_tpu stays the reference it is tested against.
"""

from .bundle import RayBundle, bundle_from_jax, concatenate_rays
from .engine import (TraceAccum, TraceOptions, TraceResult, TracerEngine,
                     trace_fused, trace_streaming)
from .parallel import (TracerEngineMP, multi_ray_sim, trace_sharded,
                       trace_streaming_sharded)
from .scene import (Assembly, AssembledObject, SceneMeta, SceneTable,
                    Surface, compile_scene, scene_from_jax)
from . import (engine, geometry, materials, parallel, sampling, scene,
               sources, spatial, stl_utils, vector_utils)

__version__ = "0.2.0"
__all__ = [
    "RayBundle", "bundle_from_jax", "concatenate_rays", "TraceAccum", "TraceOptions",
    "TraceResult", "TracerEngine", "trace_fused", "trace_streaming",
    "TracerEngineMP", "multi_ray_sim", "trace_sharded",
    "trace_streaming_sharded", "parallel",
    "Assembly", "AssembledObject", "SceneMeta", "SceneTable", "Surface",
    "compile_scene", "scene_from_jax", "engine", "geometry", "materials",
    "sampling", "scene", "sources", "spatial", "stl_utils", "vector_utils",
]
