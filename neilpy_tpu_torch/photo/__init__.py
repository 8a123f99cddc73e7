"""Photogrammetry helpers on the host: GNSS logs (``gnss``) and EXIF
geotags (``exif``), copies of the JAX package's ``photo/`` (nothing here
runs on the card)."""
