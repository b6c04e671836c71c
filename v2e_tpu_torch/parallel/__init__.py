"""Several devices (port of v2e_tpu/parallel/).

* the emulator's pixel plane in row strips over a mesh's `spatial` axis
  (mesh.py), bit-exact against one device: K1 runs once per strip with
  each frame's maximum exchanged across the strips inside the kernels;
* a chunk's time segments over a 1-D `seg` mesh (convert.py);
* SuperSloMo training data-parallel over `torch.distributed` ranks
  (models/train.py: `replicate_state`, `shard_batch`).
"""

from v2e_tpu_torch.parallel.mesh import emulate_chunk_sharded, make_mesh, shard_emulator_args

__all__ = ["make_mesh", "shard_emulator_args", "emulate_chunk_sharded"]
