"""One module per app a traffic mix can name (its ``app`` key).

Each defines ``App(graph, traffic, device)`` with:

- ``describe()``: a line saying what the trials run;
- ``warm_up()``: one iteration-capped trial through the program;
- ``trial(k, stats)``: trial ``k`` through the program, its answer returned
  and its iterations written to ``stats["iters"]``;
- ``control(k, dtype)``: trial ``k`` through the plain reference in
  ``dtype``, by default bfloat16, the precision below the configuration's
  float32 (the check's control, never timed);
- ``references(ks)``: ``{k: (answer, frontier)}`` from the plain reference;
- ``compare(answer, reference)``: ``{number: value}`` for one trial, each
  number held to its limit in ``limits/<cell>.json``;
- ``WEIGHTED``: whether the app needs the graph's weights;
- ``EDGE_BYTES``: bytes the app's semantics read for each edge it relaxes.
"""
