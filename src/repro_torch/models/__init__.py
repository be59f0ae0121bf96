"""Models of the port: the GraphIR decoder LM (:mod:`.graph_lm`) and the
layer-stack decoder LM (:mod:`.lm` over :mod:`.stack`)."""
