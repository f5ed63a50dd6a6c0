"""Short-read pipeline of the port: fused step and mapper."""
