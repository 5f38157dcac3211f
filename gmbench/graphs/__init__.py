"""Graph generators, one file each, found by the ``generator`` key of a
configuration.  Each has ``draw(config, seed, device) -> Edges``: the edge
list in input order with an int32 length per edge, made on ``device`` from
the seed."""
