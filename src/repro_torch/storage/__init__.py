"""Storage layer: delta-block serialization and the DeltaStore."""
