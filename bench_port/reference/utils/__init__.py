"""Error-free transforms (a copy of the port's `utils/fastmath.py`)."""
