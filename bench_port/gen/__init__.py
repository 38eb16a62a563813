"""Corpus generators, one module a configuration (gen/<config>.py), each
with `generate(config, seed, device, reads=None) -> Corpus`."""
