"""The model zoo of the port: the dense, MoE, SSM and hybrid decoders, the
VLM (``vision_stub``) and encoder-only (``audio_stub``) models
(``model_zoo``), their building blocks (``common``), the MoE layer
(``moe``) and the Mamba2 blocks (``mamba``)."""
