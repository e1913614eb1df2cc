"""PyTorch/CUDA port of the POTUS reproduction.

A second package beside the JAX reference ``repro``: module names mirror
the reference's, so each port module has one reference module to be held
against. It imports ``torch`` and numpy and nothing of the reference.
Entry point: ``repro_torch.core.simulate(EngineSpec(...))``, on CUDA unless
``device="cpu"``. The hand-written kernels live in ``repro_torch.kernels``.
"""
