"""One module per traffic-mix kind: the generator of its inputs from the
seed and the runner that drives the port with them (``run(ctx)``). A mix
file names its kind; a new mix of an existing kind is a data file only.
"""
