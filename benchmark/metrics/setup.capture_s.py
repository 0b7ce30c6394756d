"""Seconds the program took to capture the train step in a CUDA graph
(`make_train_bundle(...).capture.capture_s`), part of set-up."""


def read(records):
    return records.get("capture_s")
