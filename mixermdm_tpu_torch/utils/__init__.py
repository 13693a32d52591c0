"""Geometry and normalisation used by the sampling chain (f32 throughout)."""
