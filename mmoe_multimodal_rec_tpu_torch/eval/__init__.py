"""Serving: the Predictor and its HTTP front-end."""
