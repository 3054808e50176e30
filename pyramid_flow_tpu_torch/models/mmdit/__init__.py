"""The SD3 MMDiT, the repo's second DiT family."""
