"""setup_s: seconds from the process's start to the window's start
(loading, drawing the weights, building kernels, capturing graphs, warm-up
steps).  Host clock."""


def read(rec):
    return rec["setup_s"]
