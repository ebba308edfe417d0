"""Entry points of the port: ``serve`` (batched LM serving), ``train``
(the training loop) and ``elastic`` (the re-mesh coordinator, a copy)."""
