"""vqengine_tpu_torch — the PyTorch/CUDA port of vqengine_tpu for NVIDIA
Hopper (H100, sm_90a).

The JAX package ``vqengine_tpu`` stays the reference. This package mirrors
its layout (``ops/``, ``render/``, ``engine/``, ``scene/``, ``utils/``)
and imports torch, never jax, and nothing of the JAX package: it keeps its
own copies of the numpy host modules it needs (``scene/*``, ``utils/*``,
``render/scene_buffers.py``, ``render/debug_draw.py``), verbatim apart
from import lines and the parts it leaves out. The Pallas kernels it runs become
hand-written CUDA kernels in ``csrc/``, each with a plain PyTorch version
beside its wrapper (used for CPU tensors).

Ported so far: the forward main path (``render.graph.render_forward`` with
default flags): cull + LOD, triangle setup and binning, the G-buffer
raster kernel, the palette kernel, untextured materials, direct-light
shading and the tonemapper; and the shadow path: shadow-map rendering
on the visibility raster kernel, ESM and PCF shadow tests, and cached
shadow maps of static casters.
"""
