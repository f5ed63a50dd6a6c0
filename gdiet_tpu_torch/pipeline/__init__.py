"""Mapping pipelines of the port: the short-read fused step and mapper,
the long-read front and mapper."""
