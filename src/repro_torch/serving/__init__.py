"""Serving: serving-mode params and the continuous-batching runtime."""
