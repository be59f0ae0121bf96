"""Launchers of the port: the serving entry point (:mod:`.serve`)."""
