"""The plain reference: the same training, in plain PyTorch, from the same
seed's weights and data, with none of the port's code.  It imports nothing
of ``repro_torch`` and runs its float32 work with TF32 off."""
