"""Channels, bit packing and decoders, each kernel beside its plain version."""
