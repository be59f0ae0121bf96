"""Models of the port: the GraphIR decoder LM (:mod:`.graph_lm`)."""
