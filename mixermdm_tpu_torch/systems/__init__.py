"""User-facing assemblies: :class:`MixerMDMSystem` and the in2IN parts it uses."""
