"""Checkpoints (single host); the multi-device re-mesh is not ported."""
