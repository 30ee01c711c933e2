"""Scale-out layer of the port: the batching PlacementEngine
(`engine.get_engine`, one per device), its device-resident world
(`world.DeviceWorld`), and the serving mesh (`sharded`).

The two parallel axes of the mesh:
- the wave batch: independent ready waves (distinct namespaces from the
  broker's wave dequeue) scored concurrently, over the 'wave' axis;
- the node axis: the 10K-100K node matrix of one eval, over the
  'node_shard' axis, with pmax/pmin collectives for the global argmax.

`wave_mesh_shape` factors a device count into the (node_shard, wave)
grid; NOMAD_TPU_WAVE_SHARDS pins the wave extent.
"""

from nomad_tpu_torch.parallel.sharded import (
    make_mesh,
    place_eval_batch_sharded,
    stack_inputs,
    wave_mesh_shape,
)

__all__ = ["make_mesh", "place_eval_batch_sharded", "stack_inputs",
           "wave_mesh_shape"]
