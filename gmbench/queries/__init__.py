"""Query kinds, one file each, found by the ``kind`` of a traffic file's
entry.  A kind module has:

* ``NUMBERS``: the names of the numbers its check gives;
* ``prepare(graph, lengths, args) -> state``: once, in set-up
  (``lengths``: the edge lengths in CSR slot order on the device);
* ``call(state, root) -> (answer, info)``: one query through the program
  (a kind without a root ignores it),
  the entry the window times; ``answer`` is a tensor of one value per
  node slot, ``info`` a dict of host numbers the call returned;
* ``control(state, root)``: the same query through the program's path in
  the next lower precision, where it has one, else absent;
* ``check(samples, edges, args) -> {number: value}``: the comparison of
  the sampled answers (``gmbench.edges.Sample``, on the host) with the
  plain reference over the edge list ``edges``.
"""
