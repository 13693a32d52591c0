"""Training data: the InterHuman and HumanML3D datasets, synthetic fixtures
in their layouts, and a batching loader (numpy, on the host)."""
