"""QMC sampling: Owen-scrambled sequences and bokeh distributions (numpy,
host), the device sample tables, and the on-the-fly Sobol chain."""
