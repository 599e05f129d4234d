"""Routes over more than one image or device: the device mesh and the batch
route (`mesh`), one image column-sharded over a mesh (`spatial`, with its
exchange layer `shards`), the same over several processes (`multihost`),
and a dry run of both routes over n devices (`dryrun`)."""
