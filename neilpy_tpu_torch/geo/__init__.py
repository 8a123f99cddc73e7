"""Geodesy on the host: pure-numpy coordinate transforms (``proj``), the
NTv2 datum-shift grids (``ntv2``) and the EGM96 geoid (``geoid``), copies
of the JAX package's ``geo/`` (nothing here runs on the card)."""
