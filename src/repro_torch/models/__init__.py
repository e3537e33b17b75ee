"""Model definitions: the decoder families (dense, MoE, SSM, hybrid,
vision stub), the whisper encoder-decoder, and decode."""
