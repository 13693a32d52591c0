"""torch modules of the sampling path (denoisers, mixer, text towers)."""
