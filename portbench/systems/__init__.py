"""How the benchmark drives the port for each configuration, one module
each (``<config>.py``, a ``Cell`` class): inputs from the seed, the
warm-up, one job of the closed loop, and the judgement of what the timed
path produced against the plain reference."""
