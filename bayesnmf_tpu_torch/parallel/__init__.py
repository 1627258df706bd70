"""Chain ensembles of the port."""
