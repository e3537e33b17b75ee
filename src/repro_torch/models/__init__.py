"""Model definitions of the train path (dense and MoE decoders)."""
