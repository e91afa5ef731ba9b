"""tracer_tpu_torch: the PyTorch / CUDA port of tracer_tpu.

Two slices run end to end:

* the NSTTF heliostat-field trace: scene build (scene, models.nsttf),
  per-tile relevancy culling (culling), the culled streaming trace
  (engine.trace_streaming) on two hand-written CUDA kernels for Hopper
  (kernels/csrc/bounce.cu), and the receiver flux map
  (analysis.device_fluxmap);
* the TAU MiniDish (models.tau_minidish) through the host-stepped
  engine.TracerEngine.ray_tracer, with per-bounce records, and
  engine.trace_fused, on the nearest-hit kernel (kernels/csrc/nearest.cu)
  and the shade pass (kernels/shade.py).

Entry points put their tensors on the GPU (device.default_device) and
raise without one unless given ``device="cpu"``. On CPU tensors every
kernel runs its plain PyTorch version. The package imports torch and
never jax; tracer_tpu stays the reference it is tested against.
"""

from .bundle import RayBundle, bundle_from_jax
from .engine import (TraceAccum, TraceOptions, TraceResult, TracerEngine,
                     trace_fused, trace_streaming)
from .scene import (Assembly, AssembledObject, SceneMeta, SceneTable,
                    Surface, compile_scene, scene_from_jax)
from . import engine, geometry, materials, scene, sources, spatial

__version__ = "0.2.0"
__all__ = [
    "RayBundle", "bundle_from_jax", "TraceAccum", "TraceOptions",
    "TraceResult", "TracerEngine", "trace_fused", "trace_streaming",
    "Assembly", "AssembledObject", "SceneMeta", "SceneTable", "Surface",
    "compile_scene", "scene_from_jax", "engine", "geometry", "materials",
    "scene", "sources", "spatial",
]
