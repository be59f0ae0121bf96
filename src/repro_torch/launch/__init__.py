"""Launchers of the port: the serving entry point (:mod:`.serve`), the
training driver (:mod:`.train`) and the paper's Fig. 2 CNN evaluation
(:mod:`.cnn_eval`)."""
