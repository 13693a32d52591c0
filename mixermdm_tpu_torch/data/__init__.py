"""Training data: the InterHuman dataset, a synthetic fixture in its layout,
and a batching loader (numpy, on the host)."""
