"""The front-end stages and the fused per-scan step."""
