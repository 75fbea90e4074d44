"""The benchmark of ``sgcdet_tpu_torch`` on NVIDIA H100 cards: one command
runs one cell once (``python3 -m benchmark.run``); BENCHMARK.json at the
repository's root lists the cells and metrics, and the files here hold
everything that a cell reads (configs/, traffic/, modes/, limits/,
metrics/) and the yardstick (the plain reference, the work arithmetic,
the check)."""
