"""art — a wavefront path tracer built on JAX/XLA.

Feature-parity target: slbouknight/accelerated-ray-tracer (CUDA megakernel
path tracer implementing the "Ray Tracing in One Weekend" + "The Next Week"
feature set).  The architecture is a from-scratch wavefront redesign:

* the divergent CUDA megakernel (reference src/main.cu:107-133) becomes
  wavefront path tracing over SoA ray batches advanced by ``lax.while_loop``;
* virtual-dispatch hittable traversal (reference src/hittable.cuh:23-34)
  becomes type-segmented batched intersection over sphere/quad/box/medium
  tables;
* per-pixel mutable curandState (reference src/main.cu:89-105) becomes
  counter-based threefry keys folded per (tile, sample-chunk, bounce, site);
* device-side object graphs built with ``new`` (reference src/main.cu:160-635)
  become a host-side scene-builder DSL compiled to flat jnp tables.
"""

from art_tpu.scene.builder import SceneBuilder, CompiledScene
from art_tpu.render.renderer import render_scene, RenderConfig
from art_tpu.models import SCENES, build_scene, scene_defaults

__version__ = "0.1.0"

__all__ = [
    "SceneBuilder",
    "CompiledScene",
    "render_scene",
    "RenderConfig",
    "SCENES",
    "build_scene",
    "scene_defaults",
]
