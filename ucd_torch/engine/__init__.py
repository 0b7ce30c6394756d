"""Engine of the port: the train and validate steps, train-state
construction and metrics; inference npz loading, the Predictor and the
micro-batching HTTP server."""
