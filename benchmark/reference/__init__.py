"""The benchmark's plain reference of SGCDet: float32 PyTorch and NumPy,
importing nothing of the program (``model``, ``ops``, ``decode``,
``train``)."""
