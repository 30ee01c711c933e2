"""Scale-out layer of the port: the batching PlacementEngine
(`engine.get_engine`, one per device) and its device-resident world
(`world.DeviceWorld`).  Single-device; the serving mesh comes later."""
