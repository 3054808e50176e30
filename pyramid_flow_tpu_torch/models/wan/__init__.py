"""Wan2.1's T2V DiT, the repo's third DiT family."""
