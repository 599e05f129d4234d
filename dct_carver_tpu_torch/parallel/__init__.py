"""Routes over more than one image or device: the device mesh and the batch
route (`mesh`), and one image column-sharded over a mesh (`spatial`, with
its exchange layer `shards`)."""
