"""Geometry, normalisation and host-side motion features: the sampling
chain's tensors (f32), the data path's and the skeleton's numpy."""
