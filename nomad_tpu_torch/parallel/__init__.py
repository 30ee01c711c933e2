"""Scale-out layer of the port.  This slice holds only the engine seam
(`engine.get_engine`); the batching engine and the mesh come later."""
