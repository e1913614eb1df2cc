"""The model zoo of the port: the dense decoder (``model_zoo``) and its
building blocks (``common``). Mixture-of-experts, SSM and hybrid models are
not ported yet."""
