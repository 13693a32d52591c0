"""Training data: the InterHuman and HumanML3D datasets, synthetic fixtures
in their layouts, the native motion-feature library behind the InterHuman
items, and a batching loader with worker threads (numpy, on the host)."""
