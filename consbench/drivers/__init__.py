"""Entry kinds of the benchmark: one module per kind, named by a traffic
file's ``driver``, each with a ``Driver`` class and its ``SPAN``."""
