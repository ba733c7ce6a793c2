"""Plain references the benchmark compares the program with: plain
``torch`` / ``numpy``, importing nothing of the program or of JAX."""
