"""Serving steps over the models: prefill and greedy decode."""
