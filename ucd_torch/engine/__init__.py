"""Serving engine of the port: inference npz loading, the Predictor, the
micro-batching HTTP server (the train/eval engine comes with later
slices)."""
