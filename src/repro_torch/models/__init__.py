"""Models of the port: the GraphIR decoder LM (:mod:`.graph_lm`), the
layer-stack decoder LM (:mod:`.lm` over :mod:`.stack`) and the paper's
five evaluation CNNs (:mod:`.cnn`)."""
