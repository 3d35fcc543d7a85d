"""repro_torch.layers — the model layers (PyTorch port of ``repro.layers``).

Plain functions on tensors, as the reference's are plain ``jnp``: its model
code calls no Pallas kernel.  Each ``init_*`` draws its weights from a
:class:`Init` (a seeded ``torch.Generator`` on a device) with the
reference's shapes, dtypes and standard deviations; the values are the
port's own (the reference's arrive through
:func:`repro_torch.models.lm.params_from_numpy`).
"""
