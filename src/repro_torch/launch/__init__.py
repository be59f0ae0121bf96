"""Launchers of the port: the serving entry point (:mod:`.serve`) and the
paper's Fig. 2 CNN evaluation (:mod:`.cnn_eval`)."""
