"""Evaluation and serving: AUC, the streamed eval pass with HoME's
BatchNorm recalibration, the Predictor and its HTTP front-end."""
