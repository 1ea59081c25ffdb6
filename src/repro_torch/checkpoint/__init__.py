"""BVLSM checkpoints: tensor chunks as big values, META as the WAL-committed record."""
