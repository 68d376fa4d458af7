"""Test references of the port: the NumPy oracle (:mod:`.oracle`) and the
uint32 NumPy draws it reads (:mod:`.rng_np`). Not imported by the package's
``__init__``; neither module computes with torch."""
