"""tinynerf — a JAX radiance-field training framework.

Built from scratch in JAX/XLA with the full capability surface of the
reference `loicmagne/tinynerf` (see SURVEY.md): three field families (vanilla
NeRF, K-Planes, Cobafa), AABB and unbounded (Mip-NeRF-360 contracted) scenes,
Instant-NGP-style occupancy-grid culling with decay, constant-sample batching,
Blender-synthetic + nerfstudio data loading, and a fused per-ray
transmittance/weights op (the reference's CUDA kernel, rebuilt as a
segmented per-ray scan with a closed-form custom VJP).

Design stance (static shapes for XLA, not a port):
  * pure functions + pytree params, one jitted train step, static shapes
  * raggedness handled by fixed-capacity sample compaction, not dynamic shapes
  * data parallelism over rays via jax.sharding.Mesh + shard_map + psum
"""

__version__ = "0.1.0"
