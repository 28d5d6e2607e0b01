"""Nodes of the cell's captured chunk step, its branch bodies' included
(the program's own count, ``CUDAGraphEngine.graph_nodes``)."""


def read(ctx):
    return ctx.counters.get("graph_nodes")
