"""The model zoo of the port: the dense, SSM and hybrid decoders
(``model_zoo``), their building blocks (``common``) and the Mamba2 blocks
(``mamba``). Mixture-of-experts and encoder models are not ported yet."""
