"""Sampler state, Gibbs step, MAP, convergence and the fit loop."""
