"""Entry points of the port: ``serve`` (batched LM serving), ``train``
(the training loop, sharded on a mesh with ``shd``), ``dryrun`` (a step
on meta tensors, on one card or a production mesh), ``mesh`` (the
DeviceMeshes) and ``elastic`` (the re-mesh coordinator, a copy)."""
